"""The port's CLI (``iv_interpolation_tpu_torch/cli.py``, ``iv-tpu-torch``)
against the JAX package's ``iv-tpu``: the same JSON keys for the same
task, the staged job and the audits on a parquet store, ``--task stream``
on ``run_stream_replay`` with the port's config, ``--task surface``
(``--method``, ``--parity``) against the JAX CLI's surface table, ``--task
serve`` over both transports, ``--validate-only``, ``--estimate`` and
``--profile`` (or ``monitoring.enable_profiler``) with the JAX CLI's keys,
and the operator's flags (``--check-db``, ``--storage postgres`` against
the loopback mock server, ``--visualize``, ``--monitor``,
``--with-monitor``) running. CPU runs pass ``--device cpu``.
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


@pytest.fixture
def pg_server(monkeypatch):
    """The loopback PostgreSQL mock, named by the ``IVTPU_STORAGE__PG_*``
    settings."""
    from tests.pg_mock_server import MockPgServer
    with MockPgServer(auth="scram-sha-256", user="ivtpu", password="secret") as srv:
        for k, v in dict(HOST="127.0.0.1", PORT=str(srv.port), DATABASE="test",
                         USER="ivtpu", PASSWORD="secret").items():
            monkeypatch.setenv(f"IVTPU_STORAGE__PG_{k}", v)
        yield srv


def _seed_parquet(root, n=3):
    from iv_interpolation_tpu_torch.pipeline.sample_data import generate_sample_tickers
    from iv_interpolation_tpu_torch.pipeline.storage import TICKERS, ParquetStore
    ParquetStore(str(root)).write(TICKERS, generate_sample_tickers(num_symbols=n, hours=12))


OPERATOR_CASES = {
    # case: (argv, exit code, what the output holds)
    "check-db memory": (["--check-db", "--storage", "memory", "--json"], 0,
                        '{"ok": true, "backend": "memory", "tables": 0}'),
    "check-db postgres": (["--check-db", "--storage", "postgres", "--json"], 0,
                          '"permissions": {"create_table": true'),
    "check-db no server": (["--check-db", "--storage", "postgres", "--json"], 1,
                           '{"ok": false, "backend": "postgres", "error"'),
    "postgres pipeline --test": (["--storage", "postgres", "--task", "pipeline", "--test",
                                  "--json"], 0, '"task2": {"task": "candles"'),
    "visualize": (["--visualize", "--plot-dir", "plots", "--storage", "parquet",
                   "--data-root", "data", "--json"], 0, '"pipeline_complete": true'),
    "visualize --plot-symbol": (["--visualize", "--plot-dir", "plots", "--plot-symbol", "SYM",
                                 "--storage", "parquet", "--data-root", "data"], 0,
                                "=== visualization report ==="),
    "monitor": (["--monitor", "--storage", "parquet", "--data-root", "data"], 0,
                "batch complete"),
    "monitor, no runs": (["--monitor", "--storage", "memory"], 0, "no run manifests found"),
    "surface --monitor": (["--task", "surface", "--monitor", "--storage", "memory"], 0,
                          "no run manifests found"),
    "with-monitor": (["--with-monitor", "--task", "pipeline", "--storage", "parquet",
                      "--data-root", "data", "--json"], 0, "[interpolation]"),
}


@pytest.mark.parametrize("case", list(OPERATOR_CASES))
def test_operator_flags_run(in_tmp, capfd, monkeypatch, pg_server, case):
    """The flags the port used to refuse with exit 2 (``--check-db``, the
    postgres backend, ``--visualize`` with ``--plot-dir`` and
    ``--plot-symbol``, ``--monitor``, ``--with-monitor``) run, as the JAX
    CLI's do. A parquet store of three symbols (run once through the fused
    pipeline for the readers) or the mock server stands behind them."""
    argv, rc, expect = OPERATOR_CASES[case]
    if "data" in argv:
        _seed_parquet(in_tmp / "data")
        if case != "with-monitor":
            assert cli.main(["--task", "pipeline", "--storage", "parquet", "--data-root",
                             "data", "--device", "cpu", "--json"]) == 0
    if case == "check-db no server":
        pg_server.close()
    if case == "postgres pipeline --test":
        from iv_interpolation_tpu_torch.pipeline.sample_data import generate_sample_tickers
        from iv_interpolation_tpu_torch.pipeline.storage import TICKERS, PostgresStore
        PostgresStore("127.0.0.1", "test", "ivtpu", "secret", port=pg_server.port).write(
            TICKERS, generate_sample_tickers(num_symbols=2, hours=12))
    if case == "with-monitor":
        monkeypatch.setenv("IVTPU_PROCESSING__BATCH_SIZE", "1")
        monkeypatch.setenv("IVTPU_CHECKPOINT__CHECKPOINT_INTERVAL", "1")
        monkeypatch.setenv("IVTPU_MONITORING__REFRESH_INTERVAL_S", "1.0")
        _seed_parquet(in_tmp / "data", 24)
    if "SYM" in argv:
        from iv_interpolation_tpu_torch.pipeline.storage import ParquetStore
        argv = [a if a != "SYM" else ParquetStore("data").list_symbols("minute_candles")[1]
                for a in argv]
    capfd.readouterr()
    assert cli.main(argv + ["--device", "cpu"]) == rc
    out = capfd.readouterr().out
    assert expect in out, out[-3000:]
    if case.startswith("visualize"):
        assert len(list((in_tmp / "plots").glob("*.png"))) == 3   # no surfaces fitted
    if case == "postgres pipeline --test":
        res = _json_lines_of(out)[-1]
        assert res["task2"]["by_status"] == {"completed": 2}
        assert res["status"]["reconstructed_candles"]["rows"] > 0


def _json_lines_of(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith(("{", "["))]


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


def _cli_env(tmp, **overrides):
    """A CLI subprocess's environment: no launcher or JAX variables, run
    files under ``tmp``, group timeouts of 60 s."""
    from iv_interpolation_tpu_torch.parallel.dryrun import outside_world_env
    env = outside_world_env()
    env.update(IVTPU_CHECKPOINT__MANIFEST_DIR=str(tmp / "runs"),
               IVTPU_MONITORING__LOG_DIR=str(tmp / "logs"),
               IVTPU_MONITORING__ENABLE_SNAPSHOTS="false", OMP_NUM_THREADS="2",
               IVTPU_DIST_TIMEOUT_S="60", **overrides)
    return env


def test_pipeline_under_torch_distributed_run(tmp_path):
    """``python -m torch.distributed.run --standalone --nproc-per-node 2``
    of ``--task pipeline`` with ``IVTPU_PROCESSING__MESH_SHAPE=2``: exit 0,
    one JSON summary (rank 0's, naming the gloo world), and the tables of a
    one-process run of the same store. A mesh larger than the world exits
    2 with the message, on every rank of the world and in one process."""
    import re
    import shutil
    import subprocess
    import sys

    from iv_interpolation_tpu_torch.parallel.shardproof import _read_tables, assert_tables_equal
    data = tmp_path / "data"
    base = ["-m", "iv_interpolation_tpu_torch.cli", "--storage", "parquet", "--device", "cpu",
            "--json", "--env", "testing", "--yes"]

    def start(name, argv, root, env, extra=()):
        # output to files, so the runs below go on side by side
        with open(tmp_path / f"{name}.out", "w") as out, open(tmp_path / f"{name}.err", "w") as err:
            return subprocess.Popen([sys.executable, *extra, *argv, "--data-root", str(root)],
                                    cwd=tmp_path, env=env, stdout=out, stderr=err)

    def finish(name, proc):
        proc.wait(timeout=300)
        return subprocess.CompletedProcess(proc.args, proc.returncode,
                                           (tmp_path / f"{name}.out").read_text(),
                                           (tmp_path / f"{name}.err").read_text())

    gen = finish("gen", start("gen", base + ["--generate-sample-tickers", "--symbols", "12"],
                              data, _cli_env(tmp_path)))
    assert gen.returncode == 0, gen.stderr[-3000:]
    shutil.copytree(data, tmp_path / "single")
    shutil.copytree(data, tmp_path / "spare")
    torchrun = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2"]
    runs = {
        "mesh": start("mesh", base + ["--task", "pipeline"], data,
                      _cli_env(tmp_path / "mesh", IVTPU_PROCESSING__MESH_SHAPE="2",
                               IVTPU_PROCESSING__BATCH_SIZE="8"), torchrun),
        "single": start("single", base + ["--task", "pipeline"], tmp_path / "single",
                        _cli_env(tmp_path / "one", IVTPU_PROCESSING__BATCH_SIZE="8")),
        "too_big": start("too_big", base + ["--task", "pipeline"], tmp_path / "spare",
                         _cli_env(tmp_path / "big", IVTPU_PROCESSING__MESH_SHAPE="4"), torchrun),
        "alone": start("alone", base + ["--task", "pipeline"], tmp_path / "spare",
                       _cli_env(tmp_path / "alone", IVTPU_PROCESSING__MESH_SHAPE="2")),
    }
    mesh, single, too_big, alone = (finish(name, proc) for name, proc in runs.items())
    assert mesh.returncode == 0, mesh.stderr[-4000:]
    summaries = [json.loads(ln) for ln in mesh.stdout.splitlines() if ln.startswith("{")]
    assert len(summaries) == 1, mesh.stdout[-3000:]
    (summary,) = summaries
    assert summary["task2"]["by_status"] == {"completed": 12}
    assert summary["world"]["size"] == 2 and summary["world"]["backend"] == "gloo"
    assert summary["world"]["mesh_shape"] == {"data": 2}
    assert single.returncode == 0, single.stderr[-3000:]
    assert assert_tables_equal(_read_tables(str(data)), _read_tables(str(tmp_path / "single")),
                               "cpu") == 0
    # each rank exits 2; the launcher reports its failed ranks with exit 1
    assert too_big.returncode == 1 and "needs 4 ranks; 2 launched" in too_big.stderr
    assert re.search(r"exitcode\s*:\s*2", too_big.stderr), too_big.stderr[-3000:]
    assert alone.returncode == 2 and "needs 2 ranks; 1 launched" in alone.stderr
    assert not [ln for ln in alone.stdout.splitlines() if ln.startswith("{")]
