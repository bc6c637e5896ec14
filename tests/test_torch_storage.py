"""Port parity: the port's stores (``pipeline/storage.py``) and run
manifests (``pipeline/manifest.py``) against the JAX package's.

The stores keep their upsert and read semantics; a parquet store and a
manifest written by either package read back unchanged in the other
(frames equal, records and summaries equal), and a JAX-written manifest
resumes in the port.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pandas as pd
import pytest

from iv_interpolation_tpu.pipeline import manifest as ref_manifest
from iv_interpolation_tpu.pipeline import storage as ref_st
from iv_interpolation_tpu.pipeline.sample_data import generate_sample_tickers
from iv_interpolation_tpu_torch.config import StorageConfig
from iv_interpolation_tpu_torch.pipeline import manifest as port_manifest
from iv_interpolation_tpu_torch.pipeline import storage as st


def _make(kind, path):
    return st.MemoryStore() if kind == "memory" else st.ParquetStore(str(path))


@pytest.mark.parametrize("kind", ["memory", "parquet"])
def test_store_upsert_and_read_semantics(tmp_path, kind):
    store = _make(kind, tmp_path / "data")
    df = pd.DataFrame({
        "symbol": ["a", "a", "b"],
        "timestamp": pd.date_range("2023-01-01", periods=3, freq="1min"),
        "open": [1.0, 2.0, 3.0],
    })
    assert store.write("t", df) == 3 and store.write("t", df.iloc[:0]) == 0
    assert store.count("t") == 3
    assert store.list_symbols("t") == ["a", "b"] and store.tables() == ["t"]
    # upsert: overwrite one row, add one
    df2 = pd.concat([df.iloc[[0]].assign(open=9.0), pd.DataFrame({
        "symbol": ["c"], "timestamp": [pd.Timestamp("2023-01-01")], "open": [5.0]})])
    store.write("t", df2, upsert_keys=["symbol", "timestamp"])
    out = store.read("t")
    exact = store.count("t", exact=True) if kind == "parquet" else store.count("t")
    assert exact == 4 and len(out) == 4
    assert out[out["symbol"] == "a"].sort_values("timestamp")["open"].iloc[0] == 9.0
    assert set(store.read("t", symbols=["a"])["symbol"]) == {"a"}
    assert list(store.read("t", columns=["open"]).columns) == ["open"]
    store.drop("t")
    assert store.count("t") == 0 and store.read("t").empty and store.list_symbols("t") == []


def test_parquet_compact_keeps_the_upserted_table(tmp_path):
    store = st.ParquetStore(str(tmp_path / "data"))
    df = generate_sample_tickers(num_symbols=3, hours=4)
    store.write(st.TICKERS, df, upsert_keys=["symbol", "date"])
    store.write(st.TICKERS, df.iloc[:5].assign(iv=0.1), upsert_keys=["symbol", "date"])
    before = store.read(st.TICKERS)
    assert len(store._parts(st.TICKERS)) == 2
    store.compact(st.TICKERS)
    assert len(store._parts(st.TICKERS)) == 1
    pd.testing.assert_frame_equal(store.read(st.TICKERS), before)
    assert store.count(st.TICKERS) == len(df)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parquet_store_carries_across(tmp_path, writer):
    """A store written by one package reads back unchanged in the other,
    upserts included; the layout (parts, _meta.json) is the same."""
    root = str(tmp_path / "data")
    w = ref_st.ParquetStore(root) if writer == "jax" else st.ParquetStore(root)
    r = st.ParquetStore(root) if writer == "jax" else ref_st.ParquetStore(root)
    tickers = generate_sample_tickers(num_symbols=4, hours=6, seed=2)
    w.write(st.TICKERS, tickers, upsert_keys=["symbol", "date"])
    w.write(st.TICKERS, tickers.iloc[3:9].assign(iv=0.25), upsert_keys=["symbol", "date"])
    cat = pd.DataFrame({"symbol": pd.Categorical(["x", "y"]),
                        "timestamp": pd.to_datetime(["2023-03-20 09:00", "2023-03-20 09:01"]),
                        "open": np.array([1.5, 2.5], np.float32)})
    w.write(st.MINUTE_CANDLES, cat, upsert_keys=["symbol", "timestamp"])
    assert r.tables() == w.tables() == sorted([st.TICKERS, st.MINUTE_CANDLES])
    for table in r.tables():
        pd.testing.assert_frame_equal(r.read(table), w.read(table))
        assert r.list_symbols(table) == w.list_symbols(table)
        assert r.count(table) == w.count(table)
        assert r.count(table, exact=True) == w.count(table, exact=True)
    syms = sorted(tickers["symbol"].unique())[:2]
    pd.testing.assert_frame_equal(r.read(st.TICKERS, symbols=syms, columns=["symbol", "iv"]),
                                  w.read(st.TICKERS, symbols=syms, columns=["symbol", "iv"]))
    with open(os.path.join(root, st.TICKERS, "_meta.json")) as f:
        assert json.load(f) == {"upsert_keys": ["symbol", "date"]}
    # the reader's own upsert lands on the writer's table
    r.write(st.TICKERS, tickers.iloc[:2].assign(iv=0.5), upsert_keys=["symbol", "date"])
    pd.testing.assert_frame_equal(r.read(st.TICKERS), w.read(st.TICKERS))
    assert (w.read(st.TICKERS).set_index(["symbol", "date"]).loc[
        list(zip(tickers["symbol"].iloc[:2], tickers["date"].iloc[:2])), "iv"] == 0.5).all()


def test_store_names_and_backends(tmp_path, monkeypatch):
    for name in ("TICKERS", "INTERPOLATED", "MINUTE_CANDLES", "RECONSTRUCTED"):
        assert getattr(st, name) == getattr(ref_st, name)
    assert isinstance(st.get_store(StorageConfig(backend="memory")), st.MemoryStore)
    assert isinstance(st.get_store(StorageConfig(root=str(tmp_path / "d"))), st.ParquetStore)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        st.get_store(StorageConfig(backend="postgres"))
    with pytest.raises(ValueError, match="unknown storage backend"):
        st.get_store(StorageConfig(backend="sqlite"))
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(ImportError, match="ParquetStore needs pyarrow"):
        st.ParquetStore(str(tmp_path / "e"))


def _jax_manifest(d):
    m = ref_manifest.RunManifest(d, "interpolation", 1700000000, flush_interval=3)
    m.initialize_symbols(["a", "b", "c", "d", "e"])
    m.start_symbol("a", input_rows=7)
    m.complete_symbol("a", input_rows=7, output_rows=421, processing_time=0.25)
    m.error_symbol("b", "boom " * 200, processing_time=0.5)
    m.skip_symbol("c", "insufficient data points: 3 < 10")
    m.start_symbol("d", input_rows=4)        # the crash signature
    m.flush()
    return m


def test_jax_manifest_reads_and_resumes_in_the_port(tmp_path):
    d = str(tmp_path / "runs")
    jm = _jax_manifest(d)
    pm = port_manifest.RunManifest(d, "interpolation", jm.batch_id)
    assert pm.path == jm.path
    assert {s: dataclasses.asdict(r) for s, r in pm.records().items()} == \
        {s: dataclasses.asdict(r) for s, r in jm.records().items()}
    assert pm.summary() == jm.summary()
    assert pm.pending_symbols() == jm.pending_symbols() == ["b", "d", "e"]
    # the port resumes: its events land in the same jsonl, which the JAX
    # package reads back
    for s in pm.pending_symbols():
        pm.complete_symbol(s, input_rows=5, output_rows=10, processing_time=0.1)
    pm.flush()
    again = ref_manifest.RunManifest(d, "interpolation", jm.batch_id)
    assert again.is_done() and again.summary() == pm.summary()
    assert again.summary()["by_status"] == {"completed": 4, "skipped": 1}
    assert port_manifest.RunManifest.list_batches(d) == \
        ref_manifest.RunManifest.list_batches(d)


def test_port_manifest_reads_in_jax_and_lists_like_it(tmp_path):
    d = str(tmp_path / "runs")
    pm = port_manifest.RunManifest(d, "bridge", flush_interval=10)
    pm.initialize_symbols([f"s{i}" for i in range(4)])
    assert not os.path.exists(pm.path)        # buffered
    pm.complete_symbol("s0", 3, 9, 0.1)
    pm.flush()
    jm = ref_manifest.RunManifest(d, "bridge", pm.batch_id)
    assert jm.summary() == pm.summary() and len(jm.records()) == 4
    # a second run in the same second gets its own file
    assert port_manifest.RunManifest(d, "bridge").batch_id != pm.batch_id
    with open(os.path.join(d, "bridge_99.jsonl"), "w") as f:
        f.write('{"symbol": "x", "status": "pending", "mystery_field": 1}\n')
    listed = port_manifest.RunManifest.list_batches(d, task="bridge")
    assert listed == ref_manifest.RunManifest.list_batches(d, task="bridge")
    assert [b["batch_id"] for b in listed] == [pm.batch_id]
