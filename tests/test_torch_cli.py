"""The port's CLI (``iv_interpolation_tpu_torch/cli.py``, ``iv-tpu-torch``)
against the JAX package's ``iv-tpu``: the same JSON keys for the same
task, the staged job and the audits on a parquet store, ``--task stream``
on ``run_stream_replay`` with the port's config, ``--task surface``
(``--method``, ``--parity``) against the JAX CLI's surface table, ``--task
serve`` over both transports, ``--validate-only``, ``--estimate`` and
``--profile`` (or ``monitoring.enable_profiler``) with the JAX CLI's keys,
and every flag that is not ported refused with exit code 2. CPU runs pass
``--device cpu``.
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
    ["--monitor"], ["--with-monitor"], ["--visualize"], ["--plot-dir", "p"],
    ["--plot-symbol", "s"], ["--check-db"], ["--task", "surface", "--monitor"],
    ["--storage", "postgres"]])
def test_unported_tasks_and_flags_exit_2(in_tmp, capsys, args):
    assert cli.main(args + ["--device", "cpu"]) == 2
    assert "not ported yet (ROADMAP" in capsys.readouterr().err


@pytest.mark.parametrize("args,rc,keys", [
    (["--task", "surface", "--method", "rbf"], 0, {"surface", "wall_s", "status"}),
    (["--task", "surface", "--method", "ah"], 0, {"surface", "wall_s", "status"}),
    (["--method", "rbf"], 0, {"task1", "bridge", "task2", "wall_s", "status"}),
    (["--validate-only", "--task", "interpolation"], 1, {"ready", "task", "checks"}),
    (["--estimate"], 0, {"input_rows", "symbols", "estimated_output_rows",
                         "measured_grid_points_per_s", "estimated_seconds",
                         "estimated_minutes"}),
])
def test_flags_and_families_that_run(in_tmp, capsys, args, rc, keys):
    """What the port refused before it had the families and validate.py:
    each runs on an empty memory store with the JAX CLI's keys (an empty
    store is not ready for task 1)."""
    assert cli.main(args + ["--storage", "memory", "--device", "cpu", "--json"]) == rc
    assert keys <= set(_json_lines(capsys)[-1])


def test_bad_shard_and_init_env(in_tmp, capsys):
    for shard in ("1", "2/2", "x/y"):
        assert cli.main(["--shard", shard, "--storage", "memory", "--device", "cpu"]) == 2
    assert cli.main(["--init-env", "--data-root", str(in_tmp / "d")]) == 0
    assert "IVTPU_PROCESSING__BATCH_SIZE" in (in_tmp / "d" / ".env").read_text()
    assert cli.main(["--init-env", "--data-root", str(in_tmp / "d")]) == 1


@pytest.mark.parametrize("how", ["--profile", "monitoring.enable_profiler"])
def test_profile_writes_a_torch_profiler_trace(in_tmp, capsys, monkeypatch, how):
    """``--profile`` or ``IVTPU_MONITORING__ENABLE_PROFILER=true`` wraps
    the run in a ``torch.profiler`` trace written to
    ``monitoring.profiler_dir``, and the JSON reports ``profile_dir`` as
    the JAX CLI's does."""
    prof = in_tmp / "prof"
    monkeypatch.setenv("IVTPU_MONITORING__PROFILER_DIR", str(prof))
    argv = ["--task", "pipeline", "--storage", "memory", "--test", "--json", "--device", "cpu"]
    if how == "--profile":
        argv.append("--profile")
    else:
        monkeypatch.setenv("IVTPU_MONITORING__ENABLE_PROFILER", "true")
    assert cli.main(argv) == 0
    out = _json_lines(capsys)[-1]
    assert out["profile_dir"] == str(prof)
    traces = list(prof.glob("trace_*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert "traceEvents" in json.loads(traces[0].read_text())


def test_unported_family_names_its_roadmap_item(in_tmp, capsys):
    """Every family of ``--method`` is ported: rbf and ah run (an empty
    store has no data to fit); a name outside the families is an
    argparse error."""
    for method in ("rbf", "ah"):
        assert cli.main(["--task", "surface", "--method", method, "--storage", "memory",
                         "--device", "cpu", "--json"]) == 0
        assert _json_lines(capsys)[-1]["surface"]["reason"] == "no interpolated data"
    with pytest.raises(SystemExit):
        cli.main(["--method", "nonsense"])


def test_surface_task_matches_the_jax_cli(in_tmp, capsys, monkeypatch):
    """``--task surface`` with each family (the summaries hold flags and
    counts; ah on a 65-point grid with 6 iterations, both packages) and
    ``--parity`` on the same parquet store as the JAX CLI: the same
    summaries and the same check audit keys. The stores are filled by each
    package's task 1."""
    monkeypatch.setenv("IVTPU_SURFACE__AH_GRID", "65")
    monkeypatch.setenv("IVTPU_SURFACE__AH_ITERS", "6")
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
            audit = _json_lines(capsys)[-1]
            # after the audit: AH's Black-inverted wings hold iv 0, which
            # the audit's iv range flags in both packages
            for method in ("ah", "rbf"):
                assert main(base + ["--task", "surface", "--method", method]) == 0
                runs.append(_json_lines(capsys)[-1])
            outs[name] = runs, audit
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
