"""Port parity: ``iv_interpolation_tpu_torch/pipeline/validate.py`` and
``monitoring.metrics.profile_trace`` against the JAX package's
``validate_readiness`` / ``estimate_processing`` (the checks of
``tests/test_tools.py``) on the same stores, CPU tensors. Keys and
readiness verdicts exact; the estimate's numbers positive (a CPU timing
says nothing of the card). On this CPU-only torch a run aimed at the card
reports the device not ready instead of raising.
"""

import json

import pytest
import torch

from iv_interpolation_tpu.config import get_config as ref_get_config
from iv_interpolation_tpu.pipeline import MemoryStore as RefMemoryStore
from iv_interpolation_tpu.pipeline import storage as ref_st
from iv_interpolation_tpu.pipeline.sample_data import generate_sample_tickers
from iv_interpolation_tpu.pipeline.validate import estimate_processing as ref_estimate
from iv_interpolation_tpu.pipeline.validate import validate_readiness as ref_readiness
from iv_interpolation_tpu_torch.config import get_config
from iv_interpolation_tpu_torch.monitoring.metrics import profile_trace
from iv_interpolation_tpu_torch.pipeline import storage as st
from iv_interpolation_tpu_torch.pipeline.validate import (estimate_processing,
                                                          validate_readiness)


@pytest.fixture(scope="module")
def stores():
    """An empty pair of stores and a pair holding 3 symbols of tickers."""
    tickers = generate_sample_tickers(num_symbols=3)
    ref_full, full = RefMemoryStore(), st.MemoryStore()
    ref_full.write(ref_st.TICKERS, tickers, upsert_keys=["symbol", "date"])
    full.write(st.TICKERS, tickers, upsert_keys=["symbol", "date"])
    return {"empty": (RefMemoryStore(), st.MemoryStore()), "full": (ref_full, full)}


@pytest.mark.parametrize("which,task", [("empty", "interpolation"), ("full", "interpolation"),
                                        ("full", "all"), ("empty", "surface")])
def test_validate_readiness_matches_jax(stores, which, task):
    ref_store, store = stores[which]
    got = validate_readiness(get_config("testing"), store, task=task, device="cpu")
    want = ref_readiness(ref_get_config("testing"), ref_store, task=task)
    assert set(got) == set(want) and got["task"] == want["task"] == task
    assert got["ready"] == want["ready"] == (which == "full")
    assert set(got["checks"]) == set(want["checks"])
    for name, check in want["checks"].items():
        assert set(check) <= set(got["checks"][name]), name
        assert got["checks"][name]["ok"] == check["ok"], name
        if name.startswith("table_"):
            assert got["checks"][name] == check
    assert got["checks"]["device"] == {"ok": True, "platform": "cpu", "count": 1, "kind": "cpu"}


def test_readiness_for_the_card_without_one(stores, tmp_path, monkeypatch, capsys):
    """Aimed at the card on a machine without one: not ready, with the
    device check saying so, and nothing raises; ``--validate-only``
    without ``--device cpu`` exits 1 with that report."""
    from iv_interpolation_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a card is visible: this checks the machine without one")
    rep = validate_readiness(get_config("testing"), stores["full"][1], device="cuda")
    assert rep["ready"] is False
    assert rep["checks"]["device"]["ok"] is False and rep["checks"]["device"]["count"] == 0
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--validate-only", "--storage", "memory", "--json"]) == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ready"] is False and out["checks"]["device"]["ok"] is False


def test_estimate_processing_matches_jax_keys(stores):
    ref_store, store = stores["full"]
    got = estimate_processing(get_config("testing"), store, device="cpu")
    want = ref_estimate(ref_get_config("testing"), ref_store)
    assert set(got) == set(want)
    for key in ("input_rows", "symbols", "estimated_output_rows"):
        assert got[key] == want[key], key
    assert got["input_rows"] > 0 and got["measured_grid_points_per_s"] > 0
    assert got["estimated_seconds"] >= 0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "prof")):
        torch.ones(64).cumsum(0)
    (trace,) = (tmp_path / "prof").glob("trace_*.json")
    assert "traceEvents" in json.loads(trace.read_text())
    with profile_trace(None):                      # no directory: no trace
        pass
