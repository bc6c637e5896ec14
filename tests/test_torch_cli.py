"""The port's CLI (``iv_interpolation_tpu_torch/cli.py``, ``iv-tpu-torch``)
against the JAX package's ``iv-tpu``: the same JSON keys for the same
task, the staged job and the audits on a parquet store, ``--task stream``
on ``run_stream_replay`` with the port's config, and every task or flag
that is not ported refused with exit code 2. CPU runs pass
``--device cpu``.
"""

import json

import jax
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
    summary, task1, task2 = _json_lines(capsys)
    assert summary["pipeline_complete"] and task1["ok"] and task2["ok"]
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
    ["--task", "surface"], ["--task", "serve"], ["--method", "svi"], ["--parity"],
    ["--monitor"], ["--with-monitor"], ["--visualize"], ["--plot-dir", "p"],
    ["--plot-symbol", "s"], ["--check-db"], ["--profile"], ["--validate-only"],
    ["--estimate"], ["--serve-port", "9000"], ["--serve-transport", "flight"],
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
