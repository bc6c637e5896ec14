"""The port's native host packer (``iv_interpolation_tpu_torch/native``,
``csrc/packer.cpp``) and its use in ingest and the runner.

Every comparison is bit-exact: the packer copies float32 values, so its
grids and rows must equal NumPy's fancy indexing (NaN payloads included)
and the JAX package's native packer, whose side is skipped as
``tests/test_native.py`` skips it when that library cannot be built. A
fused ``PipelineRunner`` run with the native packer leaves the same three
tables as one that takes NumPy.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from iv_interpolation_tpu import native as ref_native
from iv_interpolation_tpu_torch import native
from iv_interpolation_tpu_torch.config import get_config
from iv_interpolation_tpu_torch.pipeline import ingest
from iv_interpolation_tpu_torch.pipeline import storage as st
from iv_interpolation_tpu_torch.pipeline.runner import PipelineRunner
from iv_interpolation_tpu_torch.pipeline.sample_data import generate_sample_tickers

REPO = Path(__file__).resolve().parents[1]
requires_native = pytest.mark.skipif(
    not native.native_available(), reason=f"no C++ compiler: {native.build_error}")
requires_ref_native = pytest.mark.skipif(
    not ref_native.native_available(), reason="native toolchain unavailable (g++/make)")
KEYS = {st.INTERPOLATED: ["symbol", "date"], st.MINUTE_CANDLES: ["symbol", "timestamp"],
        st.RECONSTRUCTED: ["symbol", "timestamp", "frequency"]}


def _scatter_case(rng, R=500, C=8, B=10, L=64):
    colmat = rng.normal(size=(R, C)).astype(np.float32)
    colmat[::7, 2] = np.nan
    row_sym = rng.integers(0, B, R).astype(np.int32)
    row_pos = rng.integers(0, L, R).astype(np.int64)
    # one row per (symbol, slot): the scatter order is unspecified
    _, keep = np.unique(row_sym.astype(np.int64) * L + row_pos, return_index=True)
    on_grid = np.zeros(R, np.uint8)
    on_grid[keep] = rng.uniform(size=len(keep)) < 0.9
    return colmat, row_sym, row_pos, on_grid, (B, C, L)


def _empty(shape):
    B, C, L = shape
    return ingest.full_nan((B, C, L), np.float32), np.zeros((B, L), bool)


def _numpy_scatter(colmat, row_sym, row_pos, on_grid, shape):
    values, mask = _empty(shape)
    sel = on_grid.astype(bool)
    values[row_sym[sel], :, row_pos[sel]] = colmat[sel]
    mask[row_sym[sel], row_pos[sel]] = True
    return values, mask


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@requires_native
def test_scatter_pack_is_bit_exact_against_numpy(rng):
    case = _scatter_case(rng)
    values, mask = _empty(case[-1])
    assert native.scatter_pack(*case[:4], values, mask)
    want_v, want_m = _numpy_scatter(*case)
    np.testing.assert_array_equal(_bits(values), _bits(want_v))
    np.testing.assert_array_equal(mask, want_m)


@requires_native
@requires_ref_native
def test_scatter_pack_is_bit_exact_against_the_jax_package(rng):
    case = _scatter_case(rng, R=2000, C=5, B=16, L=256)
    got, ref = _empty(case[-1]), _empty(case[-1])
    assert native.scatter_pack(*case[:4], *got)
    assert ref_native.scatter_pack(*case[:4], *ref)
    np.testing.assert_array_equal(_bits(got[0]), _bits(ref[0]))
    np.testing.assert_array_equal(got[1], ref[1])


@requires_native
@pytest.mark.parametrize("shape,N", [((6, 5, 32), 40), ((3, 8, 1000), 2500), ((1, 1, 1), 3)])
def test_gather_unpack_is_bit_exact(rng, shape, N):
    values = rng.normal(size=shape).astype(np.float32)
    values.reshape(-1)[::5] = np.nan
    out_sym = rng.integers(0, shape[0], N).astype(np.int32)
    out_pos = rng.integers(0, shape[2], N).astype(np.int64)
    got = native.gather_unpack(values, out_sym, out_pos)
    np.testing.assert_array_equal(_bits(got), _bits(values[out_sym, :, out_pos]))
    if ref_native.native_available():
        np.testing.assert_array_equal(
            _bits(got), _bits(ref_native.gather_unpack(values, out_sym, out_pos)))


@requires_native
def test_out_of_range_indices_and_mismatched_shapes_raise(rng):
    """The native loops index without checks, so the binding checks every
    index it hands them (off-grid rows are never read, as in the JAX
    package) and the shapes."""
    colmat, row_sym, row_pos, on_grid, shape = _scatter_case(rng, B=4, L=8)
    values, mask = _empty(shape)
    bad = row_pos.copy()
    bad[np.flatnonzero(on_grid)[0]] = 8
    with pytest.raises(IndexError):
        native.scatter_pack(colmat, row_sym, bad, on_grid, values, mask)
    bad[np.flatnonzero(on_grid)[0]] = 0
    bad[np.flatnonzero(on_grid == 0)[0]] = 99                # off the grid: not read
    assert native.scatter_pack(colmat, row_sym, bad, on_grid, values, mask)
    with pytest.raises(ValueError):
        native.scatter_pack(colmat, row_sym, row_pos, on_grid, values, mask[:, :4].copy())
    grids = rng.normal(size=(3, 2, 5)).astype(np.float32)
    with pytest.raises(IndexError):
        native.gather_unpack(grids, np.array([3], np.int32), np.array([0], np.int64))
    with pytest.raises(IndexError):
        native.gather_unpack(grids, np.array([0], np.int32), np.array([-1], np.int64))
    with pytest.raises(ValueError):
        native.gather_unpack(grids, np.array([0, 1], np.int32), np.array([0], np.int64))


def test_float64_and_a_missing_library_take_numpy(rng, monkeypatch, tmp_path):
    values = rng.normal(size=(2, 3, 4))
    assert native.gather_unpack(values, np.zeros(2, np.int32), np.zeros(2, np.int64)) is None
    case = _scatter_case(rng, B=4, L=8)
    grids = (np.zeros((4, 8, 8)), np.zeros((4, 8), bool))
    assert not native.scatter_pack(case[0].astype(np.float64), *case[1:4], *grids)
    # no compiler: the library is not built, the entry points say so and
    # the callers keep NumPy's answer
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_compiler", lambda: None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not native.native_available()
    assert "no C++ compiler" in native.build_error
    f32 = values.astype(np.float32)
    sel_b, sel_pos = np.array([1, 0, 1]), np.array([3, 2, 0])
    before = ingest.PACKER_CALLS["gather numpy"]
    np.testing.assert_array_equal(ingest.gather_rows(f32, sel_b, sel_pos), f32[sel_b, :, sel_pos])
    assert ingest.PACKER_CALLS["gather numpy"] == before + 1
    assert not (tmp_path / "native").exists() or not any((tmp_path / "native").iterdir())


@requires_native
def test_parallel_builds_leave_one_whole_library(tmp_path):
    """Processes that build at once (parallel test workers) each load a
    whole library: it is written under a temporary name and moved into
    place."""
    code = ("import sys, numpy as np; from pathlib import Path; "
            "from iv_interpolation_tpu_torch import native; "
            "native.BUILD_DIR = Path(sys.argv[1]); "
            "v = np.arange(24, dtype=np.float32).reshape(2, 3, 4); "
            "out = native.gather_unpack(v, np.array([1], np.int32), np.array([2], np.int64)); "
            "assert native.native_available(), native.build_error; "
            "print(native.library_path().name, out.tolist())")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [o[1] for o in outs]
    assert len({o[0] for o in outs}) == 1 and "[[14.0, 18.0, 22.0]]" in outs[0][0]
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path().name]


@requires_native
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_densify_and_host_grids_match_numpy(rng, monkeypatch, dtype):
    """``PackedBatch.densify`` (and the runner's host grids, which share
    ``ingest.scatter_rows``) equal NumPy's scatter; float32 goes through
    the native packer, float64 through NumPy."""
    R, C, B, L = 300, 8, 12, 96
    obs_vals = rng.normal(size=(R, C)).astype(dtype)
    key = rng.choice(B * L, R, replace=False)
    obs_row, obs_pos = (key // L).astype(np.int32), (key % L).astype(np.int64)
    obs_row[-20:] = B                                   # padding entries
    kind = "native" if dtype == np.float32 else "numpy"
    before = ingest.PACKER_CALLS[f"scatter {kind}"]
    got_v, got_m = ingest.scatter_rows(obs_vals, obs_row, obs_pos, B, L)
    assert ingest.PACKER_CALLS[f"scatter {kind}"] == before + 1
    monkeypatch.setattr(native, "scatter_pack", lambda *a: False)
    want_v, want_m = ingest.scatter_rows(obs_vals, obs_row, obs_pos, B, L)
    np.testing.assert_array_equal(got_v.view(np.uint8), want_v.view(np.uint8))
    np.testing.assert_array_equal(got_m, want_m)
    assert got_v.dtype == dtype and want_m[obs_row[:-20], obs_pos[:-20]].all()


def _table(store, table):
    df = store.read(table).drop(columns=["batch_id", "created_at"], errors="ignore")
    df["symbol"] = df["symbol"].astype(str)
    return df.sort_values(KEYS[table]).reset_index(drop=True)


def _run(tmp_path, name, method, tickers):
    cfg = get_config("testing")
    cfg.processing.dtype = "float32"
    cfg.interpolation.method = method
    cfg.interpolation.min_data_points = 5
    cfg.checkpoint.manifest_dir = str(tmp_path / name / "runs")
    cfg.monitoring.snapshot_dir = str(tmp_path / name / "snapshots")
    store = st.MemoryStore()
    store.write(st.TICKERS, tickers, upsert_keys=["symbol", "date"])
    runner = PipelineRunner(cfg, store=store, device="cpu")
    return runner, runner.run_pipeline_fused()


@requires_native
@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_runner_tables_equal_with_native_and_numpy_packers(tmp_path, monkeypatch, method):
    tickers = generate_sample_tickers(num_symbols=6, hours=24, seed=3)
    runner, res = _run(tmp_path, "native", method, tickers)
    assert res["packer"].get("gather native", 0) > 0 and "gather numpy" not in res["packer"]
    if method == "cubic":                  # dense batches are scattered on the host
        assert res["packer"].get("scatter native", 0) > 0
    assert runner.host_s["gather"] > 0
    monkeypatch.setattr(native, "gather_unpack", lambda *a: None)
    monkeypatch.setattr(native, "scatter_pack", lambda *a: False)
    plain, res_np = _run(tmp_path, "numpy", method, tickers)
    assert res_np["packer"].get("gather numpy", 0) > 0 and "gather native" not in res_np["packer"]
    for table in KEYS:
        got, want = _table(runner.store, table), _table(plain.store, table)
        assert len(got) > 0
        pd.testing.assert_frame_equal(got, want, check_exact=True)
