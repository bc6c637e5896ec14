"""Port parity: the JSONL serving daemon (``iv_interpolation_tpu_torch/
pipeline/serve.py``) against the JAX package's ``pipeline/serve.py``, the
ports of ``tests/test_serve.py``, and replies of both servers to the same
ticks.

Each server runs over a session of 2 underlyings (3 x 10 chains, a
128-minute window) on CPU tensors (the port) or x64 CPU arrays (JAX).
Tolerances: reply keys, flags, counts and stats exact; ``realized_vol``
and ``atm_iv`` (rounded to 6 decimals in the reply) within 2e-6, one
rounding step plus the float32 refit's rounding (the streaming tests'
128-ulp realized-vol bound is 1.5e-5 relative, far looser). Every socket
call has a 60 s timeout and every server is stopped in a ``finally``.
"""

import json
import socket

import jax.numpy as jnp
import numpy as np
import pytest

from iv_interpolation_tpu.pipeline import serve as ref_serve
from iv_interpolation_tpu.pipeline.stream_service import StreamingSession as RefSession
from iv_interpolation_tpu_torch.pipeline import serve
from iv_interpolation_tpu_torch.pipeline.stream_service import StreamingSession

TIMEOUT = 60


def _chains():
    k = np.broadcast_to(np.linspace(-0.8, 0.8, 10), (2, 3, 10)).copy()
    T = np.broadcast_to(np.array([0.1, 0.5, 1.0]), (2, 3)).copy()
    return k, 0.5 + 0.05 * k**2, T


def _port_server(flush_every=50):
    sess = StreamingSession(["btc", "eth"], *_chains(), window_minutes=128,
                            tick_capacity=1024, n_grid=10, device="cpu")
    srv = serve.StreamServer(sess, flush_every=flush_every)
    srv.start()
    return srv


@pytest.fixture
def server():
    srv = _port_server()
    try:
        yield srv
    finally:
        srv.stop()


def _ticks(rng, und, n, lo=0, hi=128):
    per_min = 0.5 / np.sqrt(365.25 * 24 * 60)
    minutes = np.sort(rng.integers(lo, hi, n))
    prices = 100 * np.exp(np.cumsum(rng.normal(0, per_min, n)))
    return [{"underlying": und, "minute": int(m), "price": float(p), "size": 1.0}
            for m, p in zip(minutes, prices)]


def _send(srv, lines):
    return serve.send_lines("127.0.0.1", srv.port, lines, timeout=TIMEOUT)


def test_ingest_flush_refit(server, rng):
    """``tests/test_serve.py::test_ingest_flush_refit``."""
    lines = _ticks(rng, "btc", 300) + _ticks(rng, "eth", 300)
    flush, refit, stats = _send(server, lines + [{"cmd": "flush"}, {"cmd": "refit"},
                                                 {"cmd": "stats"}])
    assert flush["ok"] and flush["total"] == 600
    assert refit["ok"] and set(refit["realized_vol"]) == {"btc", "eth"}
    assert 0.05 < refit["realized_vol"]["btc"] < 2.0
    assert refit["butterfly_ok"]["btc"] and refit["butterfly_ok"]["eth"]
    assert 0.4 < refit["atm_iv"]["btc"] < 0.7
    assert stats["ticks_seen"] == 600


def test_bad_json_and_unknown_cmd(server):
    with socket.create_connection(("127.0.0.1", server.port), timeout=TIMEOUT) as sock:
        f = sock.makefile("rwb")
        f.write(b"not json\n")
        f.flush()
        assert json.loads(f.readline())["ok"] is False
        f.write(b'{"cmd": "nonsense"}\n')
        f.flush()
        reply = json.loads(f.readline())
        assert reply["ok"] is False and "unknown" in reply["error"]


def test_non_dict_json_and_malformed_ticks(server, rng):
    with socket.create_connection(("127.0.0.1", server.port), timeout=TIMEOUT) as sock:
        f = sock.makefile("rwb")
        f.write(b"5\n")
        f.flush()
        reply = json.loads(f.readline())
        assert reply["ok"] is False and "object" in reply["error"]
        f.write(b'{"cmd": "stats"}\n')
        f.flush()
        assert json.loads(f.readline())["ok"] is True
    bad = [{"underlying": "btc", "minute": "noon", "price": 1.0, "size": 1.0},
           {"underlying": 7, "minute": 1, "price": 1.0, "size": 1.0},
           {"underlying": "btc", "price": 1.0, "size": 1.0}]
    (reply,) = _send(server, _ticks(rng, "btc", 10) + bad + [{"cmd": "flush"}])
    assert reply["ok"] and reply["ingested"] == 10 and reply["rejected"] == 3


def test_auto_flush_threshold(server, rng):
    (stats,) = _send(server, _ticks(rng, "btc", 120) + [{"cmd": "stats"}])
    assert stats["ticks_seen"] == 120 and stats["server_ingested"] == 120


def test_replies_match_the_jax_server(rng):
    """Both servers, the same lines (two flush batches, a late tick, an
    unknown underlying, a malformed tick, a float minute): the same
    replies, the refit's values within 2e-6."""
    lines = (_ticks(rng, "btc", 150) + _ticks(rng, "eth", 90)
             + [{"underlying": "sol", "minute": 3, "price": 9.0, "size": 1.0},
                {"underlying": "btc", "minute": 5.0, "price": 100.2, "size": 2.0},
                {"underlying": "eth", "minute": True, "price": 1.0, "size": 1.0}]
             + [{"cmd": "flush"}] + _ticks(rng, "btc", 40, lo=60)
             + [{"cmd": "refit"}, {"cmd": "stats"}, {"cmd": "flush"}])
    k, iv, T = _chains()
    ref_sess = RefSession(["btc", "eth"], jnp.asarray(k), jnp.asarray(iv), jnp.asarray(T),
                          window_minutes=128, tick_capacity=1024, n_grid=10)
    ref = ref_serve.StreamServer(ref_sess, flush_every=100)
    ref.start()
    try:
        want = ref_serve.send_lines("127.0.0.1", ref.port, lines)
    finally:
        ref.stop()
    port = _port_server(flush_every=100)
    try:
        got = _send(port, lines)
    finally:
        port.stop()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
    assert got[0] == want[0] and got[2] == want[2] and got[3] == want[3]
    assert got[1]["butterfly_ok"] == want[1]["butterfly_ok"]
    for key in ("realized_vol", "atm_iv"):
        assert set(got[1][key]) == set(want[1][key])
        for u, v in want[1][key].items():
            assert abs(got[1][key][u] - v) <= 2e-6, (key, u, got[1][key][u], v)


def test_stop_command_shuts_the_server_down(rng):
    srv = _port_server()
    try:
        (reply,) = _send(srv, _ticks(rng, "btc", 5) + [{"cmd": "stop"}])
        assert reply == {"ok": True}
        srv._thread.join(timeout=TIMEOUT)
        assert not srv._thread.is_alive()
        assert srv.session.stats()["ticks_seen"] == 5
    finally:
        srv._server.server_close()


def test_run_serve_from_store_and_synthetic_fallback(rng, tmp_path):
    """``tests/test_serve.py::test_run_serve_from_store``: the universe
    comes from the store's interpolated chains (the JAX session's, value
    for value); an empty store serves the synthetic universe."""
    from iv_interpolation_tpu.config import get_config as ref_get_config
    from iv_interpolation_tpu.pipeline import MemoryStore as RefMemoryStore
    from iv_interpolation_tpu.pipeline import PipelineRunner as RefRunner
    from iv_interpolation_tpu.pipeline import storage as ref_st
    from iv_interpolation_tpu.pipeline.sample_data import generate_sample_tickers
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline import storage as st

    ref_cfg = ref_get_config("testing")
    ref_cfg.interpolation.min_data_points = 5
    ref_cfg.processing.mesh_shape = (1,)
    ref_cfg.checkpoint.manifest_dir = str(tmp_path / "runs")
    ref_store = RefMemoryStore()
    ref_store.write(ref_st.TICKERS, generate_sample_tickers(num_symbols=60, hours=8))
    RefRunner(ref_cfg, store=ref_store).run_task1()
    cfg = get_config("testing")
    cfg.surface.grid_strikes = 10
    store = st.MemoryStore()
    store.write(st.INTERPOLATED, ref_store.read(ref_st.INTERPOLATED))

    ref_sess, ref_unds = ref_serve.build_session(ref_cfg, ref_store)
    srv = serve.run_serve(cfg, store, port=0, blocking=False, device="cpu")
    try:
        assert srv.session.underlyings == ref_unds == ["btc"]
        for a, b in (("chain_k", ref_sess.chain_k), ("chain_iv", ref_sess.chain_iv),
                     ("chain_T", ref_sess.chain_T)):
            np.testing.assert_array_equal(getattr(srv.session, a).numpy(), np.asarray(b))
        (reply,) = _send(srv, _ticks(rng, "btc", 200) + [{"cmd": "refit"}])
        assert reply["ok"] and reply["atm_iv"]["btc"] > 0
    finally:
        srv.stop()
    session, unds = serve.build_session(cfg, st.MemoryStore(), n_underlyings=3, device="cpu")
    assert unds == ["u0000", "u0001", "u0002"] and tuple(session.chain_k.shape) == (3, 4, 12)


def test_build_session_refuses_a_mesh():
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline import storage as st
    cfg = get_config("testing")
    cfg.processing.mesh_shape = (4,)
    with pytest.raises(ValueError, match="mesh"):
        serve.build_session(cfg, st.MemoryStore(), device="cpu")
