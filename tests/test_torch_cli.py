"""The port's CLI (``iv_interpolation_tpu_torch/cli.py``, ``iv-tpu-torch``)
against the JAX package's ``iv-tpu``: the same JSON keys for the same
task, the staged job and the audits on a parquet store, ``--task stream``
on ``run_stream_replay`` with the port's config, ``--task surface``
(``--method``, ``--parity``) against the JAX CLI's surface table, ``--task
serve`` over both transports, and every flag, family or config knob that
is not ported refused with exit code 2. CPU runs pass ``--device cpu``.
"""

import json
import socket
import threading
import time

import jax
import numpy as np
import pytest

from iv_interpolation_tpu import cli as ref_cli
from iv_interpolation_tpu_torch import cli
from iv_interpolation_tpu_torch.config import get_config
from iv_interpolation_tpu_torch.pipeline.stream_service import run_stream_replay


def _json_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith(("{", "["))]


@pytest.fixture
def in_tmp(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_pipeline_task_json_has_the_jax_cli_keys(in_tmp, capsys):
    argv = ["--task", "pipeline", "--storage", "memory", "--test", "--json"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = _json_lines(capsys)[-1]
    # the JAX CLI sets its compilation cache directory: restore the suite's
    cache = jax.config.jax_compilation_cache_dir
    try:
        assert ref_cli.main(argv) == 0
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    want = _json_lines(capsys)[-1]
    assert set(got) == set(want) == {"task1", "bridge", "task2", "fused", "wall_s", "status"}
    assert set(got["status"]) == set(want["status"])
    assert got["task1"]["total_symbols"] == 0


def test_staged_job_and_audits_on_a_parquet_store(in_tmp, capsys):
    root = str(in_tmp / "data")
    base = ["--storage", "parquet", "--data-root", root, "--device", "cpu", "--json",
            "--env", "testing"]
    assert cli.main(base + ["--generate-sample-tickers", "--symbols", "4"]) == 0
    assert _json_lines(capsys)[-1] == {"table": "trading_tickers", "rows": 96, "symbols": 4}
    assert cli.main(base + ["--task", "all"]) == 0
    out = _json_lines(capsys)[-1]
    for key in ("task1", "bridge", "task2"):
        assert out[key]["by_status"] == {"completed": 4}, out[key]
    assert out["status"]["reconstructed_candles"]["symbols"] == 4
    assert cli.main(base + ["--check"]) == 0
    summary, task1, task2, surface = _json_lines(capsys)
    assert summary["pipeline_complete"] and task1["ok"] and task2["ok"]
    assert surface == {"ok": False, "reason": "no fitted surfaces"}
    assert task2["invalid_ohlc_rows"] == 0
    assert cli.main(base + ["--check", "--quick"]) == 0
    assert len(_json_lines(capsys)) == 1
    assert cli.main(base + ["--list-batches"]) == 0
    listed = _json_lines(capsys)[-1]
    assert sorted(b["task"] for b in listed) == ["bridge", "candles", "interpolation"]
    bid = out["task1"]["batch_id"]
    # the staged run's manifests resume under both tasks: nothing is pending
    for task in ("pipeline", "interpolation"):
        assert cli.main(base + ["--task", task, "--resume", str(bid)]) == 0
        assert _json_lines(capsys)[-1]["task1"]["by_status"] == {"completed": 4}
    assert cli.main(base + ["--compact"]) == 0
    assert all(v["parts_after"] == 1 for v in _json_lines(capsys)[-1].values())
    for task in ("bridge", "candles", "both"):
        assert cli.main(base + ["--task", task, "--test"]) == 0
        res = _json_lines(capsys)[-1]
        assert all(s["by_status"].get("completed") == 3 for k, s in res.items()
                   if k in ("task1", "bridge", "task2")), (task, res)


def test_stream_task_runs_the_replay_with_the_port_config(in_tmp, capsys):
    assert cli.main(["--task", "stream", "--storage", "memory", "--symbols", "4",
                     "--device", "cpu", "--json"]) == 0
    out = _json_lines(capsys)[-1]["stream"]
    assert out["device"] == "cpu" and out["underlyings"] == 4 and out["butterfly_ok"] == 4
    direct = run_stream_replay(get_config("testing"), n_underlyings=3, window_minutes=40,
                               chunks=2, ticks_per_chunk=30, device="cpu")
    assert direct["ticks_ingested"] == 3 * 2 * 30 and direct["stats"]["underlyings"] == 3


@pytest.mark.parametrize("args", [
    ["--task", "surface", "--method", "rbf"], ["--task", "serve", "--method", "ah"],
    ["--monitor"], ["--with-monitor"], ["--visualize"], ["--plot-dir", "p"],
    ["--plot-symbol", "s"], ["--check-db"], ["--profile"], ["--validate-only"],
    ["--estimate"], ["--method", "rbf"], ["--task", "surface", "--monitor"],
    ["--storage", "postgres"]])
def test_unported_tasks_and_flags_exit_2(in_tmp, capsys, args):
    assert cli.main(args + ["--device", "cpu"]) == 2
    assert "not ported yet (ROADMAP" in capsys.readouterr().err


def test_bad_shard_and_init_env(in_tmp, capsys):
    for shard in ("1", "2/2", "x/y"):
        assert cli.main(["--shard", shard, "--storage", "memory", "--device", "cpu"]) == 2
    assert cli.main(["--init-env", "--data-root", str(in_tmp / "d")]) == 0
    assert "IVTPU_PROCESSING__BATCH_SIZE" in (in_tmp / "d" / ".env").read_text()
    assert cli.main(["--init-env", "--data-root", str(in_tmp / "d")]) == 1


def test_profiler_knob_is_refused_not_ignored(in_tmp, capsys, monkeypatch):
    """``monitoring.enable_profiler=true`` would need the unported profile
    trace: the CLI exits 2 naming its ROADMAP item before any work."""
    monkeypatch.setenv("IVTPU_MONITORING__ENABLE_PROFILER", "true")
    argv = ["--task", "pipeline", "--storage", "memory", "--test", "--json", "--device", "cpu"]
    assert cli.main(argv) == 2
    out = capsys.readouterr()
    assert ("monitoring.enable_profiler is not ported yet "
            "(ROADMAP: validate.py and --profile)") in out.err
    assert out.out == ""
    monkeypatch.setenv("IVTPU_MONITORING__ENABLE_PROFILER", "false")
    assert cli.main(argv) == 0


def test_unported_family_names_its_roadmap_item(in_tmp, capsys):
    for method, item in (("rbf", "A6"), ("ah", "A6")):
        assert cli.main(["--task", "surface", "--method", method, "--device", "cpu"]) == 2
        assert f"--method {method} is not ported yet (ROADMAP: {item})" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["--method", "nonsense"])


def test_surface_task_matches_the_jax_cli(in_tmp, capsys):
    """``--task surface`` with each ported family (the calibrated ones
    included: the summaries hold flags and counts) and ``--parity`` on the
    same parquet store as the JAX CLI: the same summaries and the same
    check audit keys. The stores are filled by each package's task 1."""
    cache = jax.config.jax_compilation_cache_dir
    outs = {}
    try:
        for name, main in (("port", cli.main), ("jax", ref_cli.main)):
            base = ["--storage", "parquet", "--data-root", str(in_tmp / name), "--json",
                    "--env", "testing"] + (["--device", "cpu"] if name == "port" else [])
            assert main(base + ["--generate-sample-tickers", "--symbols", "40"]) == 0
            assert main(base + ["--task", "interpolation"]) == 0
            runs = []
            for extra in ([], ["--method", "smoothing_spline"], ["--parity"],
                          ["--method", "svi"], ["--method", "essvi"], ["--method", "sabr"]):
                assert main(base + ["--task", "surface"] + extra) == 0
                runs.append(_json_lines(capsys)[-1])
            assert main(base + ["--check"]) == 0
            outs[name] = runs, _json_lines(capsys)[-1]
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    (got, got_audit), (want, want_audit) = outs["port"], outs["jax"]
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["surface"] == w["surface"]
        assert g["surface"]["surfaces"] == 1
    assert set(got_audit) == set(want_audit) and got_audit["ok"]
    assert got_audit["surfaces"] == want_audit["surfaces"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("transport", ["jsonl", "flight"])
def test_serve_task_serves_until_stopped(in_tmp, capsys, transport):
    """``--task serve`` blocks serving the synthetic universe (empty store)
    until a client stops it, then prints ``{"serve": "stopped"}``. The
    client runs in a thread (the CLI installs a signal handler, which only
    the main thread may do) with 30 s socket timeouts."""
    from iv_interpolation_tpu_torch.pipeline import flight_service, serve
    if transport == "flight" and not flight_service.HAVE_FLIGHT:
        pytest.skip("pyarrow.flight unavailable")
    port = _free_port()
    seen = []

    def client():
        deadline = time.time() + 60
        while True:
            try:
                if transport == "jsonl":
                    stats, _ = serve.send_lines("127.0.0.1", port,
                                                [{"cmd": "stats"}, {"cmd": "stop"}], timeout=30)
                else:
                    import pyarrow.flight as fl
                    conn = fl.connect(f"grpc+tcp://127.0.0.1:{port}")
                    stats = flight_service.action_json(conn, "stats")
                    flight_service.action_json(conn, "stop")
                    conn.close()
                seen.append(stats)
                return
            except Exception as e:  # noqa: BLE001 — the server is not up yet
                if time.time() > deadline:
                    seen.append(e)
                    return
                time.sleep(0.2)

    t = threading.Thread(target=client, daemon=True)
    t.start()
    rc = cli.main(["--task", "serve", "--serve-port", str(port), "--serve-transport", transport,
                   "--storage", "memory", "--symbols", "3", "--device", "cpu", "--json"])
    t.join(timeout=60)
    assert not t.is_alive() and rc == 0
    (stats,) = seen
    assert isinstance(stats, dict) and stats["ok"] and stats["underlyings"] == 3, stats
    assert _json_lines(capsys)[-1]["serve"] == "stopped"
