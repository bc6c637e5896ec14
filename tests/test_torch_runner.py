"""Port parity: the port's ``PipelineRunner`` (``pipeline/runner.py``) run
from store to store against the JAX package's ``PipelineRunner`` on the
same tickers, and the JAX runner's behaviours of
``tests/test_pipeline.py`` held on the port.

Both runners use the ``testing`` preset; the JAX one runs on one device
(``mesh_shape=(1,)``) with ``max_slots_per_batch=0``, so both pack the
same batches. Tables are compared after sorting by their upsert keys and
dropping ``batch_id`` and ``created_at``. Tolerances
(``tests/test_torch_tasks.py``):
* keys, symbols, timestamps, flags, strikes, row counts, manifest
  statuses and reasons: exact;
* float64: values within 1e-12 of max(1, |x|); greeks within 1e-12 of
  each greek's largest |value|; 5-minute volume within 1e-12 of the
  symbol's total 1-minute volume;
* float32: interpolated values within 2 ulps of max(1, |x|); greeks
  within 64 eps32 of each greek's largest |value|; 1-minute OHLCV within
  8 ulps plus one 1e-4 rounding step, a row beyond that a minimum-spread
  flip in one package, at most 1 % of rows; 5-minute prices within the
  same step unless their bucket holds such a row; 5-minute volume within
  4 eps32 of the symbol's total 1-minute volume.
The port's staged and fused tables are exactly equal to each other.
"""

import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pandas as pd
import pytest

from iv_interpolation_tpu.config import get_config as ref_get_config
from iv_interpolation_tpu.pipeline import MemoryStore as RefMemoryStore
from iv_interpolation_tpu.pipeline import ParquetStore as RefParquetStore
from iv_interpolation_tpu.pipeline import PipelineRunner as RefRunner
from iv_interpolation_tpu.pipeline import runner as ref_runner
from iv_interpolation_tpu_torch.config import get_config
from iv_interpolation_tpu_torch.pipeline import ingest
from iv_interpolation_tpu_torch.pipeline import manifest as port_manifest
from iv_interpolation_tpu_torch.pipeline import runner as port_runner
from iv_interpolation_tpu_torch.pipeline import storage as st
from iv_interpolation_tpu_torch.pipeline.manifest import RunManifest
from iv_interpolation_tpu_torch.pipeline.runner import PipelineRunner
from iv_interpolation_tpu_torch.pipeline.sample_data import generate_sample_tickers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
KEYS = {st.INTERPOLATED: ["symbol", "date"], st.MINUTE_CANDLES: ["symbol", "timestamp"],
        st.RECONSTRUCTED: ["symbol", "timestamp", "frequency"]}
GREEKS = ("delta", "gamma", "theta", "vega", "rho")
PRICES = ("open", "high", "low", "close")
STAGES = {"task1": "interpolation", "bridge": "bridge", "task2": "candles"}


def _configs(root, dtype="float64", method="linear", **processing):
    """The same settings for both packages; run files under ``root``."""
    out = []
    for name, get in (("jax", ref_get_config), ("port", get_config)):
        cfg = get("testing")
        cfg.processing.dtype = dtype
        cfg.interpolation.method = method
        cfg.interpolation.min_data_points = 5
        cfg.checkpoint.manifest_dir = str(root / name / "runs")
        cfg.monitoring.snapshot_dir = str(root / name / "snapshots")
        for k, v in processing.items():
            setattr(cfg.processing, k, v)
        if name == "jax":
            cfg.processing.mesh_shape = (1,)
            cfg.processing.max_slots_per_batch = 0
        out.append(cfg)
    return out


def _table(store, table):
    df = store.read(table)
    df = df.drop(columns=[c for c in ("batch_id", "created_at") if c in df.columns])
    df["symbol"] = df["symbol"].astype(str)
    return df.sort_values(KEYS[table]).reset_index(drop=True)


def _close(got, want, tol, scale):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    d = np.nan_to_num(np.abs(got - want))
    assert (d <= tol * scale).all(), float(d.max())


def _exact(g, w, cols):
    for c in cols:
        np.testing.assert_array_equal(g[c].to_numpy(), w[c].to_numpy(), err_msg=c)


def _assert_tables(got_store, want_store, f64, min_spread=0.0005):
    """The three tables of ``got_store`` against ``want_store`` at the
    module's tolerances."""
    gi, wi = _table(got_store, st.INTERPOLATED), _table(want_store, st.INTERPOLATED)
    assert list(gi.columns) == list(wi.columns) and len(gi) == len(wi) > 0
    _exact(gi, wi, ("symbol", "date", "strike", "callput", "is_interpolated"))
    for c in ingest.ALL_COLS:
        assert gi[c].dtype == wi[c].dtype, c
        w = wi[c].to_numpy(np.float64)
        _close(gi[c], w, 1e-12 if f64 else 2 * EPS32, np.maximum(1.0, np.abs(np.nan_to_num(w))))
    for g in GREEKS:
        _close(gi[g], wi[g], 1e-12 if f64 else 64 * EPS32, np.nanmax(np.abs(wi[g])))

    gm, wm = _table(got_store, st.MINUTE_CANDLES), _table(want_store, st.MINUTE_CANDLES)
    assert list(gm.columns) == list(wm.columns) and len(gm) == len(wm) > 0
    _exact(gm, wm, ("symbol", "timestamp"))
    beyond = np.zeros(len(wm), bool)
    for f in PRICES + ("volume",):
        assert gm[f].dtype == wm[f].dtype, f
        x, y = gm[f].to_numpy(np.float64), wm[f].to_numpy(np.float64)
        if f64:
            _close(x, y, 1e-12, np.maximum(1.0, np.abs(y)))
        else:
            beyond |= ~(np.abs(x - y) <= 8 * EPS32 * np.abs(y) + 1e-4)
    if not f64:
        assert beyond.sum() <= 0.01 * len(wm)
        base = wm.merge(wi[["symbol", "date", "underlying_price"]], how="left",
                        left_on=["symbol", "timestamp"], right_on=["symbol", "date"]
                        )["underlying_price"].to_numpy(np.float64)
        narrow = lambda m: (np.abs((m["high"].to_numpy(np.float64) - m["low"].to_numpy(np.float64))
                                   - base * min_spread) <= 2e-4 + 16 * EPS32 * base)
        assert (narrow(gm) | narrow(wm))[beyond].all()

    gr, wr = _table(got_store, st.RECONSTRUCTED), _table(want_store, st.RECONSTRUCTED)
    assert list(gr.columns) == list(wr.columns) and len(gr) == len(wr) > 0
    _exact(gr, wr, ("symbol", "timestamp", "frequency", "source_candles"))
    vol_total = wm.groupby("symbol")["volume"].apply(lambda v: np.abs(v).sum())
    scale = vol_total.reindex(wr["symbol"]).to_numpy(np.float64)
    _close(gr["volume"], wr["volume"], 1e-12 if f64 else 4 * EPS32, scale)
    excused = np.zeros(len(wr), bool)
    if not f64 and beyond.any():
        bad = set(zip(wm["symbol"][beyond], wm["timestamp"][beyond].dt.floor("5min")))
        excused = np.array([(s, t) in bad for s, t in zip(wr["symbol"], wr["timestamp"])])
    for f in PRICES:
        x, y = gr[f].to_numpy(np.float64), wr[f].to_numpy(np.float64)
        tol = 1e-12 * np.maximum(1.0, np.abs(y)) if f64 else 8 * EPS32 * np.abs(y) + 1e-4
        assert (np.abs(x - y) <= tol)[~excused].all(), f


def _summary_view(summary):
    return {k: summary[k] for k in ("total_symbols", "by_status", "input_rows",
                                    "output_rows", "expansion_ratio")}


def _assert_manifests(got_cfg, got, want_cfg, want):
    """Equal summaries, and per symbol the same status, reason and row
    counts, in every stage's manifest."""
    for key, name in STAGES.items():
        assert _summary_view(got[key]) == _summary_view(want[key]), key
        g = RunManifest(got_cfg.checkpoint.manifest_dir, name, got[key]["batch_id"]).records()
        w = RunManifest(want_cfg.checkpoint.manifest_dir, name, want[key]["batch_id"]).records()
        assert sorted(g) == sorted(w)
        for s in w:
            for f in ("status", "error_message", "input_rows", "output_rows"):
                assert getattr(g[s], f) == getattr(w[s], f), (key, s, f)


def _store(pkg, tickers):
    store = RefMemoryStore() if pkg == "jax" else st.MemoryStore()
    store.write(st.TICKERS, tickers)
    return store


@pytest.fixture(scope="module")
def tickers():
    return generate_sample_tickers(num_symbols=12, hours=48, seed=31, drop_frac=0.2)


@pytest.fixture(scope="module")
def cubic_tickers():
    df = generate_sample_tickers(num_symbols=12, hours=24, seed=32, drop_frac=0.2)
    assert df.groupby("symbol").size().nunique() > 1   # mixed observation counts
    return df


class _Record:
    """Wraps a module function while installed, recording its results."""

    def __init__(self, mod, name, pick):
        self.mod, self.name, self.pick, self.seen = mod, name, pick, []

    def __enter__(self):
        orig = self.orig = getattr(self.mod, self.name)

        def wrapped(*a, **k):
            out = orig(*a, **k)
            self.seen.append(self.pick(out))
            return out
        setattr(self.mod, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tickers, cubic_tickers):
    """Both runners over the same tickers, once per case: (configs,
    stores, summaries, what each recorded)."""
    cache = {}

    def run(case):
        if case in cache:
            return cache[case]
        mode, dtype, method = case
        data = cubic_tickers if method == "cubic" else tickers
        root = tmp_path_factory.mktemp("_".join(case))
        cfgs = _configs(root, dtype, method)
        out = {"cfg": {}, "store": {}, "summary": {}, "clean": {}, "methods": []}
        for pkg, cfg, mod, cls in (("jax", cfgs[0], ref_runner, RefRunner),
                                   ("port", cfgs[1], port_runner, PipelineRunner)):
            store = _store(pkg, data)
            runner = cls(cfg, store=store) if pkg == "jax" else cls(cfg, store=store,
                                                                    device="cpu")
            with _Record(mod, "_obs_positions", lambda r: r[1]) as clean, \
                    _Record(port_runner, "dispatch", lambda d: d["method"]) as methods:
                res = runner.run_pipeline_fused() if mode == "fused" else runner.run_all()
            out["cfg"][pkg], out["store"][pkg], out["summary"][pkg] = cfg, store, res
            out["clean"][pkg] = clean.seen
            if pkg == "port":
                out["methods"] = methods.seen
        cache[case] = out
        return out
    return run


@pytest.mark.parametrize("case", [("fused", "float32", "linear"),
                                  ("fused", "float64", "linear"),
                                  ("fused", "float64", "cubic"),
                                  ("staged", "float64", "linear")])
def test_runner_matches_jax(runs, case):
    r = runs(case)
    got, want = r["summary"]["port"], r["summary"]["jax"]
    for key in STAGES:
        assert got[key]["by_status"] == {"completed": 12}, got[key]
    assert got.get("fused", False) == want.get("fused", False)
    _assert_tables(r["store"]["port"], r["store"]["jax"], f64=case[1] == "float64")
    _assert_manifests(r["cfg"]["port"], got, r["cfg"]["jax"], want)


def test_cubic_split_runs_every_sub_batch_cubic(runs, cubic_tickers):
    """The repair: a packed batch of mixed observation counts is split,
    so every sub-batch runs the cubic spline in both packages; unsplit,
    the same batch falls back to linear."""
    r = runs(("fused", "float64", "cubic"))
    assert len(r["methods"]) > 1 and set(r["methods"]) == {"cubic"}
    assert len(r["clean"]["jax"]) == len(r["clean"]["port"]) == len(r["methods"])
    assert all(r["clean"]["jax"]) and all(r["clean"]["port"])
    cfg = r["cfg"]["port"]
    packed = ingest.pack_symbols(cubic_tickers, cfg.processing.bucket_sizes, min_points=5,
                                 max_batch=cfg.processing.batch_size, dtype=np.float64)
    assert len(packed.batches) == 1
    assert port_runner.fused_batch(packed.batches[0], cfg, "cpu")["method"] == "linear"


@pytest.mark.parametrize("dtype,method", [("float32", "linear"), ("float64", "cubic")])
def test_port_staged_equals_port_fused(tmp_path, tickers, cubic_tickers, dtype, method):
    data = cubic_tickers if method == "cubic" else tickers
    cfg = _configs(tmp_path, dtype, method)[1]
    tables = {}
    for mode in ("fused", "staged"):
        store = _store("port", data)
        runner = PipelineRunner(cfg, store=store, device="cpu")
        res = runner.run_pipeline_fused() if mode == "fused" else runner.run_all()
        assert res["task2"]["by_status"] == {"completed": 12}
        tables[mode] = {t: _table(store, t) for t in KEYS}
    for t in KEYS:
        pd.testing.assert_frame_equal(tables["staged"][t], tables["fused"][t])


def test_jax_stopped_run_resumes_in_the_port(tmp_path):
    """A fused run the JAX runner stopped after its first batch, on a
    parquet store, finishes in the port from the JAX manifests; the
    tables equal one uninterrupted JAX run's."""
    tickers = generate_sample_tickers(num_symbols=40, hours=8, seed=33)
    jcfg, pcfg = _configs(tmp_path, "float64", batch_size=16)
    pcfg.checkpoint.manifest_dir = jcfg.checkpoint.manifest_dir
    root = str(tmp_path / "data")
    jstore = RefParquetStore(root)
    jstore.write(st.TICKERS, tickers, upsert_keys=["symbol", "date"])
    stopped = RefRunner(jcfg, store=jstore)
    orig = stopped._attempt

    def stop_after_first(label, fn):
        stopped.request_stop()
        return orig(label, fn)

    stopped._attempt = stop_after_first
    s1 = stopped.run_pipeline_fused()
    assert 0 < s1["task1"]["by_status"]["pending"] < 40
    port = PipelineRunner(pcfg, store=st.ParquetStore(root), device="cpu")
    s2 = port.run_pipeline_fused(resume_batch_id=s1["task1"]["batch_id"])
    for key in STAGES:
        assert s2[key]["by_status"] == {"completed": 40}
    whole_cfg = _configs(tmp_path / "whole", "float64", batch_size=16)[0]
    whole = _store("jax", tickers)
    RefRunner(whole_cfg, store=whole).run_pipeline_fused()
    _assert_tables(port.store, whole, f64=True)


# -- the JAX runner's behaviours (tests/test_pipeline.py), on the port ------

@pytest.fixture
def cfg(tmp_path):
    return _configs(tmp_path)[1]


def _runner(cfg, tickers, store=None):
    store = store if store is not None else _store("port", tickers)
    return PipelineRunner(cfg, store=store, device="cpu")


def test_resume_reprocesses_pending_and_mid_processing_symbols(cfg):
    runner = _runner(cfg, generate_sample_tickers(num_symbols=3, hours=12))
    s1 = runner.run_task1()
    bid = s1["batch_id"]
    m = RunManifest(cfg.checkpoint.manifest_dir, "interpolation", bid)
    crashed, errored = sorted(m.records())[:2]
    m.start_symbol(crashed, input_rows=5)      # flushed start, no completion
    m.error_symbol(errored, "simulated crash")
    m.flush()
    assert RunManifest(cfg.checkpoint.manifest_dir, "interpolation",
                       bid).pending_symbols() == [crashed, errored]
    runner.run_task1(resume_batch_id=bid)
    m2 = RunManifest(cfg.checkpoint.manifest_dir, "interpolation", bid)
    assert m2.is_done() and m2.summary()["by_status"] == {"completed": 3}


def test_graceful_stop_leaves_a_resumable_manifest(cfg):
    cfg.processing.batch_size = 16
    tickers = generate_sample_tickers(num_symbols=40, hours=8)
    runner = _runner(cfg, tickers)
    orig = runner._attempt
    calls = []

    def stopping_attempt(label, fn):
        calls.append(label)
        if len(calls) == 1:
            runner.request_stop()
        return orig(label, fn)

    runner._attempt = stopping_attempt
    s1 = runner.run_task1()
    done, pending = s1["by_status"].get("completed", 0), s1["by_status"].get("pending", 0)
    assert done >= 16 and pending > 0 and done + pending == 40
    s2 = _runner(cfg, tickers, runner.store).run_task1(resume_batch_id=s1["batch_id"])
    assert s2["by_status"] == {"completed": 40}


def test_fused_skips_and_resume(cfg):
    tickers = generate_sample_tickers(num_symbols=4, hours=10)
    few = tickers[tickers["symbol"] == tickers["symbol"].iloc[0]].head(3)
    cfg.interpolation.min_data_points = 10
    runner = _runner(cfg, pd.concat([tickers, few.assign(symbol="btc-tiny-1-c")]))
    s = runner.run_pipeline_fused(symbols=sorted(tickers["symbol"].unique())
                                  + ["btc-tiny-1-c", "btc-absent-1-c"])
    for key in STAGES:
        assert s[key]["by_status"] == {"completed": 4, "skipped": 2}, s[key]
    rec = RunManifest(cfg.checkpoint.manifest_dir, "candles",
                      s["task2"]["batch_id"]).records()
    assert "insufficient data points" in rec["btc-tiny-1-c"].error_message
    assert "no observations" in rec["btc-absent-1-c"].error_message
    s2 = runner.run_pipeline_fused(resume_batch_id=s["task1"]["batch_id"])
    assert s2["task1"]["by_status"] == {"completed": 4, "skipped": 2}
    assert _runner(cfg, None, st.MemoryStore()).run_pipeline_fused()["task1"]["total_symbols"] == 0


@pytest.mark.parametrize("mode", ["staged", "fused"])
def test_quality_gate_isolates_one_symbol(cfg, mode):
    tickers = generate_sample_tickers(num_symbols=8, hours=6)
    syms = sorted(tickers["symbol"].unique())
    victim = syms[3]
    n = 30
    poison = pd.DataFrame({
        "symbol": victim, "date": pd.date_range("2023-03-20 09:00", periods=n, freq="1min"),
        "iv": 0.5, "underlying_price": np.where(np.arange(n) % 2 == 0, 100.0, 10.0),
        "time_to_maturity": 0.1, "strike": 24500.0, "callput": "c"})
    runner = _runner(cfg, pd.concat([tickers[tickers["symbol"] != victim], poison],
                                    ignore_index=True))
    res = runner.run_all() if mode == "staged" else runner.run_pipeline_fused()
    assert res["task1"]["by_status"] == {"completed": 8}
    assert res["bridge"]["by_status"] == {"completed": 7, "error": 1}
    candles = runner.store.read(st.MINUTE_CANDLES)
    assert set(candles["symbol"].astype(str)) == set(syms) - {victim}
    rec = RunManifest(cfg.checkpoint.manifest_dir, "bridge",
                      res["bridge"]["batch_id"]).records()[victim]
    assert rec.status == "error" and "quality gate" in rec.error_message


def test_transient_failure_is_retried_and_persistent_failure_errors(cfg):
    tickers = generate_sample_tickers(num_symbols=2, hours=12)
    runner = _runner(cfg, tickers)
    real_write, calls = runner.store.write, []

    def flaky_write(table, df, upsert_keys=None):
        if table == st.INTERPOLATED:
            calls.append(table)
            if len(calls) == 1:
                raise IOError("simulated transient storage failure")
        return real_write(table, df, upsert_keys=upsert_keys)

    runner.store.write = flaky_write
    assert runner.run_task1()["by_status"] == {"completed": 2} and len(calls) == 2

    cfg.checkpoint.max_retries = 1
    runner = _runner(cfg, tickers)

    def always_fail(table, df, upsert_keys=None):
        raise IOError("permanent failure")

    runner.store.write = always_fail
    summary = runner.run_task1()
    assert summary["by_status"] == {"error": 2}
    m = RunManifest(cfg.checkpoint.manifest_dir, "interpolation", summary["batch_id"])
    assert all("permanent failure" in r.error_message for r in m.records().values())


def test_failed_async_write_marks_its_symbols_error(cfg):
    tickers = generate_sample_tickers(num_symbols=3, hours=8)
    runner = _runner(cfg, tickers)
    real_write = runner.store.write

    def failing_candles(table, df, upsert_keys=None):
        if table == st.RECONSTRUCTED:
            raise IOError("disk full")
        return real_write(table, df, upsert_keys=upsert_keys)

    runner.store.write = failing_candles
    res = runner.run_pipeline_fused()
    for key in STAGES:
        assert res[key]["by_status"] == {"error": 3}, res[key]
    rec = RunManifest(cfg.checkpoint.manifest_dir, "candles", res["task2"]["batch_id"]).records()
    assert all("async write failed: disk full" in r.error_message for r in rec.values())
    # resume re-runs them once the store works again
    runner.store.write = real_write
    again = runner.run_pipeline_fused(resume_batch_id=res["task1"]["batch_id"])
    assert again["task2"]["by_status"] == {"completed": 3}


def test_chunked_reads_bound_each_read_and_match_unchunked(cfg):
    class CountingStore(st.MemoryStore):
        def __init__(self):
            super().__init__()
            self.read_sizes = []

        def read(self, table, symbols=None, columns=None):
            if symbols is not None:
                self.read_sizes.append(len(symbols))
            return super().read(table, symbols=symbols, columns=columns)

    tickers = generate_sample_tickers(num_symbols=5, hours=6)
    results = {}
    for chunk in (0, 2):
        store = CountingStore()
        store.write(st.TICKERS, tickers)
        cfg.processing.read_chunk_symbols = chunk
        res = _runner(cfg, None, store).run_pipeline_fused()
        assert res["task1"]["by_status"] == {"completed": 5}
        if chunk:
            assert max(store.read_sizes) <= chunk
        results[chunk] = _table(store, st.RECONSTRUCTED)
    pd.testing.assert_frame_equal(results[0], results[2])


def test_shards_cover_the_unsharded_run(cfg, tmp_path):
    tickers = generate_sample_tickers(num_symbols=7, hours=6)
    whole = _runner(cfg, tickers)
    whole.run_pipeline_fused()
    shared = _store("port", tickers)
    universe = sorted(tickers["symbol"].unique())
    owned = {}
    for i in (0, 1):
        cfg.processing.shard_index, cfg.processing.shard_count = i, 2
        runner = _runner(cfg, None, shared)
        part = runner._shard_symbols(universe)
        assert runner._shard_symbols(part) == part
        assert part == [s for s in universe if ref_runner.symbol_fold(s) % 2 == i]
        res = runner.run_pipeline_fused()
        owned[i] = res["task1"]["by_status"]["completed"]
        assert os.path.exists(os.path.join(cfg.checkpoint.manifest_dir,
                                           f"interpolation.shard{i}_{res['task1']['batch_id']}.jsonl"))
    assert owned[0] + owned[1] == 7 and min(owned.values()) >= 1
    for t in KEYS:
        pd.testing.assert_frame_equal(_table(shared, t), _table(whole.store, t))
    cfg.processing.shard_index = 2
    with pytest.raises(ValueError, match="shard_index"):
        _runner(cfg, None, st.MemoryStore())._shard_symbols(["AAA", "BBB"])


def test_run_all_scopes_downstream_stages(cfg):
    runner = _runner(cfg, generate_sample_tickers(num_symbols=3, hours=6))
    runner.run_all()
    res = runner.run_all(limit=1)
    for key in STAGES:
        assert res[key]["by_status"] == {"completed": 1}, key
    bid = res["task1"]["batch_id"]
    m = RunManifest(cfg.checkpoint.manifest_dir, "interpolation", bid)
    m.error_symbol(sorted(m.records())[0], "simulated crash")
    m.flush()
    res2 = runner.run_all(resume_batch_id=bid)
    assert res2["task1"]["by_status"] == {"completed": 1}
    assert res2["bridge"]["by_status"] == {"completed": 1}
    status = runner.status()
    assert status[st.TICKERS]["symbols"] == 3 and status[st.RECONSTRUCTED]["rows"] > 0


@pytest.mark.parametrize("taken", ["copied", "empty"])
def test_run_all_takes_one_batch_id_free_for_every_stage(cfg, monkeypatch, taken):
    """A fresh ``run_all`` runs its three stages under one id that no
    stage's manifest holds yet, so ``resume_batch_id`` names the same run
    in every stage whatever the clock does. The clock is held at 1000 s;
    downstream manifests at 1001 stand in for a first run whose stages
    crossed a second boundary (the id the limited run's task 1 would
    have taken alone)."""
    monkeypatch.setattr(port_manifest, "time", types.SimpleNamespace(time=lambda: 1000.0))
    runner = _runner(cfg, generate_sample_tickers(num_symbols=3, hours=6))
    first = runner.run_all()
    assert {first[k]["batch_id"] for k in STAGES} == {1000}
    d = cfg.checkpoint.manifest_dir
    for name in ("bridge", "candles"):
        dst = os.path.join(d, f"{name}_1001.jsonl")
        if taken == "copied":
            shutil.copy(os.path.join(d, f"{name}_1000.jsonl"), dst)
        else:
            open(dst, "w").close()
    res = runner.run_all(limit=1)
    assert {res[k]["batch_id"] for k in STAGES} == {1002}
    m = RunManifest(d, "interpolation", 1002)
    m.error_symbol(sorted(m.records())[0], "simulated crash")
    m.flush()
    res2 = runner.run_all(resume_batch_id=1002)
    for key in STAGES:
        assert res2[key]["batch_id"] == 1002
        assert res2[key]["by_status"] == {"completed": 1}, key
    # the fused path opens its three manifests under one free id too
    fused = runner.run_pipeline_fused(limit=1)
    assert {fused[k]["batch_id"] for k in STAGES} == {1003}


def test_date_window_batch_filter_and_duplicates(cfg):
    tickers = generate_sample_tickers(num_symbols=2, hours=24)
    dup = tickers.iloc[[3]].assign(iv=9.99)
    runner = _runner(cfg, pd.concat([tickers, dup], ignore_index=True))
    s = runner.run_task1(start_date="2023-03-20 12:00", end_date="2023-03-20 20:00")
    assert s["by_status"] == {"completed": 2}
    out = runner.store.read(st.INTERPOLATED)
    assert out["date"].min() >= pd.Timestamp("2023-03-20 12:00")
    assert len(out) == 2 * (8 * 60 + 1)
    assert runner.run_bridge(batch_id=s["batch_id"] + 999)["by_status"].get("completed", 0) == 0
    assert runner.run_bridge(batch_id=s["batch_id"])["by_status"] == {"completed": 2}
    runner.run_task1()
    row = runner.store.read(st.INTERPOLATED)
    row = row[row["date"] == tickers["date"].iloc[3]]
    assert row["iv"].round(2).tolist().count(9.99) == 1


def test_cubic_nan_at_an_observation_falls_back_to_linear(cfg, caplog):
    tickers = generate_sample_tickers(num_symbols=2, hours=12)
    tickers.loc[tickers.index[3], "iv"] = np.nan
    cfg.interpolation.method = "cubic"
    with _Record(port_runner, "dispatch", lambda d: d["method"]) as methods:
        res = _runner(cfg, tickers).run_pipeline_fused()
    assert res["task2"]["by_status"] == {"completed": 2}
    assert "linear" in methods.seen and "falling back to linear" in caplog.text


def test_runner_imports_nothing_of_jax(tmp_path):
    """In a process where ``jax`` and ``iv_interpolation_tpu`` cannot be
    imported, the port's host modules import and a 3-symbol memory-store
    pipeline runs on the CPU."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['iv_interpolation_tpu'] = None\n"
        "from iv_interpolation_tpu_torch import cli, config, utils, convert\n"
        "from iv_interpolation_tpu_torch.pipeline import (runner, ingest, storage, manifest,\n"
        "    sample_data, check_results)\n"
        "from iv_interpolation_tpu_torch.monitoring import metrics, logging\n"
        "cfg = config.get_config('testing')\n"
        "cfg.interpolation.min_data_points = 5\n"
        "store = storage.MemoryStore()\n"
        "store.write(storage.TICKERS, sample_data.generate_sample_tickers(num_symbols=3, hours=6))\n"
        "res = runner.PipelineRunner(cfg, store=store, device='cpu').run_pipeline_fused()\n"
        "assert res['task2']['by_status'] == {'completed': 3}, res\n"
        "assert check_results.check_candle_results(store)['ok']\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'iv_interpolation_tpu')\n"
        "          and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]


# ----------------------------------------------------------------------
# the runner over a mesh of ranks (parallel/mesh.py): launched worlds of
# 2 and 4 gloo CPU ranks (parallel._ranks.runner), against the port's
# unsharded run (byte for byte) and the JAX runner on its 8-device mesh
# (tests/test_pipeline.py's mesh case) at this module's tolerances
# ----------------------------------------------------------------------
MESH_SYMBOLS, MESH_HOURS, MESH_BATCH = 16, 12, 8


def _mesh_tickers():
    return generate_sample_tickers(num_symbols=MESH_SYMBOLS, hours=MESH_HOURS, drop_frac=0.1)


def _start_mesh_world(tmp, ranks, cases, **extra):
    import json
    import pickle

    from iv_interpolation_tpu_torch.parallel import dryrun
    with open(tmp / "tickers.pkl", "wb") as f:
        pickle.dump(_mesh_tickers(), f)
    args = {"device": "cpu", "out": str(tmp), "tickers": str(tmp / "tickers.pkl"),
            "cases": cases, "batch": MESH_BATCH, **extra}
    return dryrun.start_world(ranks, ["-m", "iv_interpolation_tpu_torch.parallel._ranks",
                                      "runner", json.dumps(args)], timeout_s=60)


def _finish_mesh_world(world):
    from iv_interpolation_tpu_torch.parallel import dryrun
    results = [dryrun.result_of(out) for out in world.wait(240)]
    assert all(r["jax_free"] for r in results)
    return [r["result"] for r in results]


def _mesh_store(path):
    import pickle
    with open(path, "rb") as f:
        tables = pickle.load(f)
    store = st.MemoryStore()
    for t, df in tables.items():
        store.write(t, df)
    return store


def _mesh_config(root, method="linear"):
    cfg = get_config("testing")
    cfg.processing.dtype = "float64"
    cfg.processing.batch_size = MESH_BATCH
    cfg.interpolation.method = method
    cfg.interpolation.min_data_points = 5
    cfg.checkpoint.manifest_dir = str(root / "runs")
    cfg.monitoring.enable_snapshots = False
    return cfg


@pytest.fixture(scope="module")
def unsharded(tmp_path_factory):
    """The port's one-process runs (fused, staged, cubic) of the mesh
    tickers."""
    root = tmp_path_factory.mktemp("unsharded")
    out = {}
    for case in ("fused", "staged", "cubic"):
        store = st.MemoryStore()
        store.write(st.TICKERS, _mesh_tickers())
        runner = PipelineRunner(_mesh_config(root / case, "cubic" if case == "cubic"
                                             else "linear"), store=store, device="cpu")
        assert runner.mesh is None
        (runner.run_all if case == "staged" else runner.run_pipeline_fused)()
        out[case] = store
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The runner's mesh cases in a world of 2 ranks and one of 4, launched
    together: {ranks: (output directory, each rank's result)}."""
    symbols = sorted(_mesh_tickers()["symbol"].astype(str).unique())
    tmp = {n: tmp_path_factory.mktemp(f"mesh{n}") for n in (2, 4)}
    started = {2: _start_mesh_world(tmp[2], 2, ["fused", "staged", "cubic", "resume", "fail"],
                                    fail_rank=1, fail_symbol=symbols[0]),
               4: _start_mesh_world(tmp[4], 4, ["fused", "staged"])}
    return {n: (tmp[n], _finish_mesh_world(w)) for n, w in started.items()}


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[2]


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[4]


def _byte_equal(a_store, b_store):
    for table in KEYS:
        pd.testing.assert_frame_equal(_table(a_store, table), _table(b_store, table),
                                      check_exact=True)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("case", ["fused", "staged"])
def test_mesh_tables_equal_unsharded_and_jax(world2, world4, unsharded, jax_mesh, ranks, case):
    """The runner over 2 and 4 ranks writes the one-process run's tables
    byte for byte, and the JAX runner's on its 8-device mesh at this
    module's float64 tolerances; rank 0's summary names the world."""
    tmp, results = world2 if ranks == 2 else world4
    for r, res in enumerate(results):
        assert res[case]["mesh"] == {"data": ranks} and res[case]["leader"] == (r == 0)
    got = _mesh_store(tmp / f"{case}.pkl")
    _byte_equal(got, unsharded[case])
    import pickle
    with open(tmp / f"{case}_summary.pkl", "rb") as f:
        summary = pickle.load(f)
    assert summary["task2"]["by_status"] == {"completed": MESH_SYMBOLS}
    assert summary["world"]["size"] == ranks and summary["world"]["backend"] == "gloo"
    assert len(summary["world"]["peak_bytes_by_rank"]) == ranks
    _assert_tables(got, jax_mesh(case), f64=True)


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    """The JAX runner with its 8-device mesh on the mesh tickers, by case
    (run once a case)."""
    stores = {}

    def run(case):
        if case not in stores:
            ref_cfg, _ = _configs(tmp_path_factory.mktemp(f"jax_{case}"))
            ref_cfg.processing.mesh_shape = (8,)
            ref_cfg.processing.batch_size = MESH_BATCH
            stores[case] = RefMemoryStore()
            stores[case].write(st.TICKERS, _mesh_tickers())
            ref = RefRunner(ref_cfg, store=stores[case])
            assert dict(ref.mesh.shape) == {"data": 8}
            (ref.run_all if case == "staged" else ref.run_pipeline_fused)()
        return stores[case]

    return run


def test_mesh_cubic_equals_unsharded(world2, unsharded):
    tmp, _ = world2
    _byte_equal(_mesh_store(tmp / "cubic.pkl"), unsharded["cubic"])


def test_mesh_resume_finishes_the_run(world2, unsharded):
    """Stopped after its first batch (every rank stops there), then
    resumed by its batch id: the tables of the uninterrupted run."""
    import pickle
    tmp, _ = world2
    with open(tmp / "resume_summary.pkl", "rb") as f:
        summary = pickle.load(f)
    first, resumed = summary["first"], summary["resumed"]
    assert 0 < first["task1"]["by_status"].get("completed", 0) < MESH_SYMBOLS
    assert resumed["task2"]["by_status"] == {"completed": MESH_SYMBOLS}
    assert resumed["task1"]["batch_id"] == first["task1"]["batch_id"]
    _byte_equal(_mesh_store(tmp / "resume.pkl"), unsharded["fused"])


def test_mesh_rank_failure_errors_its_batch_only(world2, unsharded):
    """Rank 1 raises in one batch on every attempt: the ranks agree before
    the gather, retry together, and that batch's symbols end in error on
    every stage; the other batch completes and nothing hangs."""
    import pickle
    tmp, results = world2
    assert results[1]["fail"]["attempts"] == 2 and results[0]["fail"]["attempts"] == 0
    with open(tmp / "fail_summary.pkl", "rb") as f:
        summary = pickle.load(f)
    batch_id = summary["task1"]["batch_id"]
    errored = None
    for stage in STAGES.values():
        records = RunManifest(str(tmp / "fail" / "runs"), stage, batch_id).records()
        bad = {s for s, r in records.items() if r.status == "error"}
        assert all("rank 1: RuntimeError: injected failure" in records[s].error_message
                   for s in bad)
        assert 0 < len(bad) < MESH_SYMBOLS and errored in (None, bad)
        assert all(r.status == "completed" for s, r in records.items() if s not in bad)
        errored = bad
    got = _table(_mesh_store(tmp / "fail.pkl"), st.INTERPOLATED)
    want = _table(unsharded["fused"], st.INTERPOLATED)
    want = want[~want["symbol"].isin(errored)].reset_index(drop=True)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
