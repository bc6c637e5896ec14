"""Port parity: the Arrow Flight transport (``iv_interpolation_tpu_torch/
pipeline/flight_service.py``), the ports of ``tests/test_flight.py``, and
its replies against the JAX package's Flight server and the port's own
JSONL server on the same ticks. Skips only when ``pyarrow.flight`` is
absent, as the JAX tests do.

Sessions of 2 underlyings (3 x 10 chains, a 128-minute window) on CPU
tensors (the port) or x64 CPU arrays (JAX). Tolerances: tables' columns,
row order and flags exact; ``realized_vol`` and ``atm_iv`` within 1e-6
of the JAX server's (the float32 refit's rounding) and within 1e-6 of the
port's JSONL reply (rounded to 6 decimals there); IV grids within 1e-6.
Every Flight call has a 60 s timeout and every server is shut down in a
``finally``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from iv_interpolation_tpu.pipeline import flight_service as ref_fs
from iv_interpolation_tpu.pipeline.stream_service import StreamingSession as RefSession
from iv_interpolation_tpu_torch.pipeline import flight_service as fs
from iv_interpolation_tpu_torch.pipeline import serve
from iv_interpolation_tpu_torch.pipeline.stream_service import StreamingSession

pytestmark = pytest.mark.skipif(not fs.HAVE_FLIGHT, reason="pyarrow.flight unavailable")
TIMEOUT = 60


def _chains():
    k = np.broadcast_to(np.linspace(-0.8, 0.8, 10), (2, 3, 10)).copy()
    T = np.broadcast_to(np.array([0.1, 0.5, 1.0]), (2, 3)).copy()
    return k, 0.5 + 0.05 * k**2, T


def _session():
    return StreamingSession(["btc", "eth"], *_chains(), window_minutes=128,
                            tick_capacity=1024, n_grid=10, device="cpu")


@pytest.fixture
def server():
    srv = fs.FlightStreamServer(_session(), port=0)
    try:
        yield srv
    finally:
        srv.shutdown()


def _tick_cols(rng, und, n, lo=0, hi=128):
    per_min = 0.5 / np.sqrt(365.25 * 24 * 60)
    minutes = np.sort(rng.integers(lo, hi, n))
    prices = 100 * np.exp(np.cumsum(rng.normal(0, per_min, n)))
    return [und] * n, minutes, prices, np.ones(n, np.float32)


def _client(srv):
    import pyarrow.flight as fl
    return fl.connect(f"grpc+tcp://127.0.0.1:{srv.port}")


def _get(client, ticket):
    import pyarrow.flight as fl
    return client.do_get(fl.Ticket(ticket),
                         options=fl.FlightCallOptions(timeout=TIMEOUT)).read_all()


def test_flight_put_refit_surfaces(server, rng):
    """``tests/test_flight.py::test_flight_put_refit_surfaces``."""
    import pyarrow.flight as fl
    client = _client(server)
    u1, m1, p1, s1 = _tick_cols(rng, "btc", 300)
    u2, m2, p2, s2 = _tick_cols(rng, "eth", 300)
    fs.put_ticks(client, u1 + u2, np.concatenate([m1, m2]), np.concatenate([p1, p2]),
                 np.concatenate([s1, s2]))
    flushed = fs.action_json(client, "flush")
    assert flushed["ok"] and flushed["total"] == 600
    assert fs.action_json(client, "stats")["ticks_seen"] == 600
    table = _get(client, b"refit")
    row = {c: table.column(c).to_pylist() for c in table.column_names}
    assert row["underlying"] == ["btc", "eth"]
    assert 0.05 < row["realized_vol"][0] < 2.0
    assert all(row["butterfly_ok"]) and all(row["calendar_ok"])
    assert 0.4 < row["atm_iv"][0] < 0.7
    surf = _get(client, b"surfaces")
    assert surf.num_rows == 2 * 3
    iv0 = np.asarray(surf.column("iv").to_pylist()[0], np.float32)
    assert iv0.shape == (10,) and np.isfinite(iv0).all() and (iv0 > 0).all()
    with pytest.raises(fl.FlightServerError):
        _get(client, b"nonsense")
    with pytest.raises(fl.FlightServerError):
        list(client.do_action(fl.Action("nonsense", b"")))
    client.close()


def test_flight_matches_the_jax_flight_server_and_jsonl(server, rng):
    """The same ticks through the JAX Flight server, the port's and the
    port's JSONL server: the same tables and numbers."""
    u = ["btc"] * 150 + ["eth"] * 120
    cols = [_tick_cols(rng, "btc", 150), _tick_cols(rng, "eth", 120)]
    m, p, s = (np.concatenate([c[i] for c in cols]) for i in (1, 2, 3))

    def run(srv, mod):
        client = _client(srv)
        try:
            mod.put_ticks(client, u, m, p, s)
            return (mod.action_json(client, "flush"), _get(client, b"refit"),
                    _get(client, b"surfaces"), mod.action_json(client, "stats"))
        finally:
            client.close()

    k, iv, T = _chains()
    ref = ref_fs.FlightStreamServer(RefSession(
        ["btc", "eth"], jnp.asarray(k), jnp.asarray(iv), jnp.asarray(T),
        window_minutes=128, tick_capacity=1024, n_grid=10), port=0)
    try:
        want = run(ref, ref_fs)
    finally:
        ref.shutdown()
    got = run(server, fs)
    assert got[0] == want[0] and got[3] == want[3]
    for a, b in ((got[1], want[1]), (got[2], want[2])):
        assert a.column_names == b.column_names and a.schema == b.schema
        for c in a.column_names:
            x, y = a.column(c).to_pylist(), b.column(c).to_pylist()
            if c in ("realized_vol", "atm_iv", "iv"):
                np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64),
                                           rtol=0, atol=1e-6, err_msg=c)
            else:
                assert x == y, c
    jsonl = serve.StreamServer(_session())
    jsonl.start()
    try:
        lines = [{"underlying": uu, "minute": int(mm), "price": float(pp), "size": float(ss)}
                 for uu, mm, pp, ss in zip(u, m, np.float32(p), s)]
        (reply,) = serve.send_lines("127.0.0.1", jsonl.port, lines + [{"cmd": "refit"}],
                                    timeout=TIMEOUT)
    finally:
        jsonl.stop()
    rv = got[1].column("realized_vol").to_pylist()
    assert abs(reply["realized_vol"]["btc"] - rv[0]) <= 1e-6
    assert reply["butterfly_ok"] == dict(zip(["btc", "eth"],
                                             got[1].column("butterfly_ok").to_pylist()))


def test_flight_robustness(server, rng):
    """``tests/test_flight.py::test_flight_robustness_review_fixes``:
    mixed-schema batches, a batch missing a column, an unknown ticket and
    the advertised port."""
    import pyarrow as pa
    import pyarrow.flight as fl
    client = _client(server)
    u, m, p, s = _tick_cols(rng, "btc", 50)
    fs.put_ticks(client, u, m, p, s)                   # float32 price
    batch64 = pa.record_batch({
        "underlying": pa.array(["eth"] * 50), "minute": pa.array(np.arange(50, dtype=np.int32)),
        "price": pa.array(np.full(50, 100.0)), "size": pa.array(np.ones(50))})
    writer, _ = client.do_put(fl.FlightDescriptor.for_path("ticks"), batch64.schema)
    writer.write_batch(batch64)
    writer.close()
    flushed = fs.action_json(client, "flush")
    assert flushed["ok"] and flushed["total"] == 100
    bad = pa.record_batch({"underlying": pa.array(["btc"]),
                           "minute": pa.array(np.array([1], np.int32)),
                           "price": pa.array(np.array([100.0], np.float32))})
    with pytest.raises(fl.FlightError, match="missing columns"):
        w, _ = client.do_put(fl.FlightDescriptor.for_path("ticks"), bad.schema)
        w.write_batch(bad)
        w.close()
    text = pa.record_batch({"underlying": pa.array(["btc"]), "minute": pa.array(["noon"]),
                            "price": pa.array([1.0]), "size": pa.array([1.0])})
    with pytest.raises(fl.FlightError, match="non-numeric"):
        w, _ = client.do_put(fl.FlightDescriptor.for_path("ticks"), text.schema)
        w.write_batch(text)
        w.close()
    assert fs.action_json(client, "stats")["ok"]
    with pytest.raises(fl.FlightError, match="unknown ticket"):
        _get(client, b"refits")
    locs = [str(loc) for info in client.list_flights() for ep in info.endpoints
            for loc in ep.locations]
    assert locs and all(str(server.port) in loc for loc in locs)
    assert [a.type for a in client.list_actions()] == ["flush", "stats", "stop"]
    client.close()


def test_stop_action_and_run_serve_flight(rng):
    """``do_action('stop')`` flushes and shuts the server down; the CLI
    entry builds its session like the JSONL server."""
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline import storage as st
    cfg = get_config("testing")
    cfg.surface.grid_strikes = 10
    srv = fs.run_serve_flight(cfg, st.MemoryStore(), port=0, n_underlyings=3,
                              blocking=False, device="cpu")
    try:
        assert srv.session.underlyings == ["u0000", "u0001", "u0002"]
        client = _client(srv)
        u, m, p, s = _tick_cols(rng, "u0001", 20)
        fs.put_ticks(client, u, m, p, s)
        assert fs.action_json(client, "stop") == {"ok": True}
        client.close()
        srv.wait()
        assert srv.session.stats()["ticks_seen"] == 20
    finally:
        srv.shutdown()
