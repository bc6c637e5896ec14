"""Port parity: ``iv_interpolation_tpu_torch/pipeline/surface_task.py`` (and
``check_results.check_surface_results``) against the JAX package's, side
by side on one interpolated table, plus the ports of the JAX suite's
surface-task tests (``tests/test_tools.py``: local-vol columns, parity
mode, prices when iv is missing, the surface audit, the float32 strike
dedupe).

The port runs on CPU tensors in ``processing.dtype = "float64"`` (the
JAX suite runs x64). Tolerances: chains (underlying, expiry, k, iv, T)
exact, except ivs inverted from prices (within 1e-9: both packages run
64 safeguarded Newton steps, with erf-based normal CDFs that differ in
the last bits); stored tables: keys, flags and row order exact, float64
values within 1e-12 of max(1, |x|), parity mode's float32 columns bit
for bit except ``iv`` (2 float32 ulps: sqrt and division round
differently between the two packages) and the low limb (within 1e-15).
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from iv_interpolation_tpu.config import get_config as ref_get_config
from iv_interpolation_tpu.pipeline import MemoryStore as RefMemoryStore
from iv_interpolation_tpu.pipeline import ParquetStore as RefParquetStore
from iv_interpolation_tpu.pipeline import PipelineRunner as RefRunner
from iv_interpolation_tpu.pipeline import storage as ref_st
from iv_interpolation_tpu.pipeline import surface_task as ref_task
from iv_interpolation_tpu.pipeline.check_results import check_surface_results as ref_audit
from iv_interpolation_tpu.pipeline.sample_data import generate_sample_tickers
from iv_interpolation_tpu_torch import models
from iv_interpolation_tpu_torch.config import get_config
from iv_interpolation_tpu_torch.pipeline import storage as st
from iv_interpolation_tpu_torch.pipeline import surface_task as task
from iv_interpolation_tpu_torch.pipeline.check_results import check_surface_results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ["underlying", "expiry_t", "log_moneyness"]
EPS32 = float(np.finfo(np.float32).eps)


def _symbols(unds=("btc", "eth"), exps=("28apr23", "30jun23", "29sep23"),
             strikes=(20000, 22000, 24000, 26000, 28000, 30000), cps="cp"):
    return [f"{u}-{e}-{k}-{cp}" for u in unds for e in exps for k in strikes for cp in cps]


@pytest.fixture(scope="module")
def interpolated(tmp_path_factory):
    """The JAX runner's interpolated table of 2 underlyings x 3 expiries x
    6 strikes x call/put, 8 hours; a few latest rows lose their iv so
    their price is inverted."""
    cfg = ref_get_config("testing")
    cfg.processing.dtype = "float64"
    cfg.processing.mesh_shape = (1,)
    cfg.interpolation.min_data_points = 5
    cfg.checkpoint.manifest_dir = str(tmp_path_factory.mktemp("runs"))
    store = RefMemoryStore()
    store.write(ref_st.TICKERS, generate_sample_tickers(hours=8, symbols=_symbols()))
    RefRunner(cfg, store=store).run_task1()
    df = store.read(ref_st.INTERPOLATED)
    last = df.groupby("symbol")["date"].transform("max") == df["date"]
    lose = last & df["symbol"].isin(["btc-28apr23-22000-c", "eth-30jun23-26000-p"])
    df.loc[lose, "iv"] = np.nan
    return df


def _configs(**surface):
    out = []
    for get in (ref_get_config, get_config):
        cfg = get("testing")
        cfg.processing.dtype = "float64"
        cfg.interpolation.min_data_points = 5
        for k, v in surface.items():
            setattr(cfg.surface, k, v)
        out.append(cfg)
    out[0].processing.mesh_shape = (1,)
    return out


def _stores(interpolated, ref_store=None, port_store=None):
    ref_store = ref_store if ref_store is not None else RefMemoryStore()
    port_store = port_store if port_store is not None else st.MemoryStore()
    ref_store.write(ref_st.INTERPOLATED, interpolated)
    port_store.write(st.INTERPOLATED, interpolated)
    return ref_store, port_store


def _sorted(df):
    return df.sort_values(KEYS).reset_index(drop=True)


def _tables_match(got, want, parity=False):
    got, want = _sorted(got), _sorted(want)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        a, b = got[c].to_numpy(), want[c].to_numpy()
        if c in ("underlying", "butterfly_ok", "calendar_ok"):
            np.testing.assert_array_equal(a, b, err_msg=c)
            continue
        assert a.dtype == b.dtype, (c, a.dtype, b.dtype)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=c)
        a, b = np.nan_to_num(a).astype(np.float64), np.nan_to_num(b).astype(np.float64)
        if parity and c == "iv":
            tol = 2 * EPS32 * np.abs(b)
        elif parity and c == "total_variance_lo":
            tol = 1e-15
        elif parity and c != "fit_rmse":
            tol = 0.0
        else:
            tol = 1e-12 * np.maximum(1.0, np.abs(b))
        assert (np.abs(a - b) <= tol).all(), (c, float(np.abs(a - b).max()))


def test_build_chains_matches_jax_chain_by_chain(interpolated):
    got = task.build_chains(interpolated, device="cpu")
    want = ref_task.build_chains(interpolated)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert (g["underlying"], g["expiry"]) == (w["underlying"], w["expiry"])
        np.testing.assert_array_equal(g["k"], w["k"])
        np.testing.assert_allclose(g["iv"], w["iv"], rtol=0, atol=1e-9)
        assert g["T"] == w["T"]
    # without inverted quotes the chains are equal value for value
    clean = interpolated.dropna(subset=["iv"])
    for g, w in zip(task.build_chains(clean, device="cpu"), ref_task.build_chains(clean)):
        np.testing.assert_array_equal(g["iv"], w["iv"])
    assert task.build_chains(interpolated.iloc[:0], device="cpu") == []


@pytest.mark.parametrize("method,surface", [
    ("cubic_spline", {}),
    ("cubic_spline", {"compute_local_vol": True}),
    ("smoothing_spline", {"compute_local_vol": True, "smoothing_lam": 1e-3}),
    ("cubic_spline", {"compensated": True}),
    ("cubic_spline", {"spline_bc": "natural"}),
])
def test_run_surface_fit_tables_match_jax(interpolated, method, surface):
    ref_cfg, cfg = _configs(smile_method=method, **surface)
    ref_store, store = _stores(interpolated)
    want = ref_task.run_surface_fit(ref_cfg, ref_store)
    got = task.run_surface_fit(cfg, store, device="cpu")
    assert got == want
    _tables_match(store.read(task.SURFACES), ref_store.read(ref_task.SURFACES),
                  parity=surface.get("compensated", False))
    # the audit agrees on the port's table
    a, b = check_surface_results(store), ref_audit(ref_store)
    assert {k: a[k] for k in ("ok", "surfaces", "grid_rows", "butterfly_ok", "calendar_ok")} \
        == {k: b[k] for k in ("ok", "surfaces", "grid_rows", "butterfly_ok", "calendar_ok")}


@pytest.mark.parametrize("method,surface", [
    ("svi", {}), ("svi", {"butterfly_penalty": 10.0, "svi_weighting": "vega"}),
    ("essvi", {}), ("essvi", {"compute_local_vol": True}), ("sabr", {}),
])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_calibrated_families_tables_match_jax(interpolated, method, surface, dtype):
    """``run_surface_fit`` with the calibrated families on the same store:
    the same summary; flags equal; the persisted grids within 1e-7 of scale
    in float64. With ``processing.dtype`` float32 the port computes and
    persists float32 while the reference, under the suite's x64 switch,
    still computes float64: the port's float32 table is held to it within
    5e-5 of each column's scale (the LM iterate paths differ by rounding),
    local vol and density within 1e-2 relative."""
    ref_cfg, cfg = _configs(smile_method=method, lm_max_iters=24, **surface)
    ref_cfg.processing.dtype = cfg.processing.dtype = dtype
    ref_store, store = _stores(interpolated)
    want = ref_task.run_surface_fit(ref_cfg, ref_store)
    got = task.run_surface_fit(cfg, store, device="cpu")
    assert got == want and got["method"] == method and got["surfaces"] == 2
    a, b = _sorted(store.read(task.SURFACES)), _sorted(ref_store.read(ref_task.SURFACES))
    assert a["total_variance"].dtype == np.dtype(dtype)
    assert list(a.columns) == list(b.columns) and len(a) == len(b)
    tol = 1e-7 if dtype == "float64" else 5e-5
    for c in b.columns:
        x, y = a[c].to_numpy(), b[c].to_numpy()
        if c in ("underlying", "butterfly_ok", "calendar_ok"):
            np.testing.assert_array_equal(x, y, err_msg=c)
            continue
        if dtype == "float64":
            assert x.dtype == y.dtype, (c, x.dtype, y.dtype)
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y), err_msg=c)
        x, y = np.nan_to_num(x).astype(np.float64), np.nan_to_num(y).astype(np.float64)
        if c in ("local_vol", "density") and dtype == "float32":
            assert (np.abs(x - y) <= 1e-2 * np.maximum(np.abs(y), np.abs(y).max() * 1e-3)).all(), c
        else:
            # iv = sqrt(w / T) amplifies a float32 w difference by 1 / (2 iv T),
            # about 10 at the shortest expiry here
            scale = 10.0 if (c == "iv" and dtype == "float32") else 1.0
            assert (np.abs(x - y) <= scale * tol * max(1.0, np.abs(y).max())).all(), \
                (c, float(np.abs(x - y).max()))


@pytest.mark.parametrize("method,surface", [
    ("ah", {"ah_grid": 65, "ah_iters": 6}),
    ("ah", {"ah_grid": 65, "ah_iters": 6, "compute_local_vol": True, "ah_max_batch": 1}),
    ("rbf", {}),
    ("rbf", {"compute_local_vol": True, "rbf_butterfly_penalty": 100.0,
             "rbf_calendar_penalty": 100.0, "rbf_penalty_iters": 4, "rbf_centers": 16}),
])
def test_ah_and_rbf_tables_match_jax(interpolated, method, surface):
    """``run_surface_fit`` with Andreasen-Huge (chunked by
    ``ah_max_batch`` or not) and RBF (direct, and penalized on a reduced
    basis) in float64 on the same store: the same summary, flags and NaN
    masks equal, fit_rmse within 1e-10, local vol and density within 1e-7
    of their scale. AH's total variance is Black-inverted from prices and
    is held in price space (normalized calls within 1e-10); RBF's within
    1e-7 of scale (its direct saddle systems here carry the padded expiry
    slots 1e-3 apart in T)."""
    from iv_interpolation_tpu_torch.ops.andreasen_huge import normalized_call

    ref_cfg, cfg = _configs(smile_method=method, **surface)
    ref_store, store = _stores(interpolated)
    want = ref_task.run_surface_fit(ref_cfg, ref_store)
    got = task.run_surface_fit(cfg, store, device="cpu")
    assert got == want and got["method"] == method and got["surfaces"] == 2
    a, b = _sorted(store.read(task.SURFACES)), _sorted(ref_store.read(ref_task.SURFACES))
    assert list(a.columns) == list(b.columns) and len(a) == len(b)
    for c in b.columns:
        x, y = a[c].to_numpy(), b[c].to_numpy()
        if c in ("underlying", "butterfly_ok", "calendar_ok"):
            np.testing.assert_array_equal(x, y, err_msg=c)
            continue
        assert x.dtype == y.dtype, (c, x.dtype, y.dtype)
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y), err_msg=c)
        x, y = np.nan_to_num(x), np.nan_to_num(y)
        if method == "ah" and c in ("total_variance", "iv"):
            if c == "iv":
                continue
            k = torch.from_numpy(b["log_moneyness"].to_numpy())
            x, y = (normalized_call(k, torch.from_numpy(v)).numpy() for v in (x, y))
            tol = 1e-10
        else:
            tol = {"fit_rmse": 1e-10}.get(c, 1e-7) * max(1.0, np.abs(y).max())
        assert (np.abs(x - y) <= tol).all(), (c, float(np.abs(x - y).max()))


def test_limit_and_float32_processing(interpolated):
    """``limit`` cuts the chains; float32 processing gives float32 grids."""
    ref_cfg, cfg = _configs()
    cfg.processing.dtype = "float32"
    _, store = _stores(interpolated)
    rep = task.run_surface_fit(cfg, store, limit=3, device="cpu")
    assert rep["surfaces"] == 1 and rep["method"] == "cubic_spline"
    df = store.read(task.SURFACES)
    assert df["total_variance"].dtype == np.float32 and df["expiry_t"].nunique() == 3


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parquet_surface_table_reads_in_both_packages(interpolated, tmp_path, writer):
    ref_cfg, cfg = _configs(compute_local_vol=True)
    ref_store, store = _stores(interpolated, RefParquetStore(str(tmp_path / "d")),
                               st.ParquetStore(str(tmp_path / "d")))
    if writer == "jax":
        ref_task.run_surface_fit(ref_cfg, ref_store)
    else:
        task.run_surface_fit(cfg, store, device="cpu")
    pd.testing.assert_frame_equal(_sorted(store.read(task.SURFACES)),
                                  _sorted(ref_store.read(ref_task.SURFACES)))
    assert check_surface_results(store)["ok"] and ref_audit(ref_store)["ok"]


def test_surface_audit_without_and_with_surfaces(interpolated):
    """``tests/test_tools.py::test_check_surface_results``."""
    _, cfg = _configs()
    _, store = _stores(interpolated)
    rep0 = check_surface_results(store)
    assert not rep0["ok"] and "no fitted surfaces" in rep0["reason"]
    task.run_surface_fit(cfg, store, device="cpu")
    rep = check_surface_results(store)
    assert rep["ok"] and rep["surfaces"] == 2 and rep["iv_range"][0] > 0
    assert rep["worst_fit_rmse"] < 1e-12


def test_local_vol_columns_and_parity_mode_one_underlying(tmp_path):
    """``tests/test_tools.py::test_surface_task_local_vol_columns`` and
    ``::test_surface_task_parity_mode``: one underlying, 2 expiries x 6
    strikes, through the JAX runner's task 1."""
    ref_cfg, cfg = _configs(compute_local_vol=True)
    ref_cfg.checkpoint.manifest_dir = str(tmp_path / "runs")
    ref_store = RefMemoryStore()
    ref_store.write(ref_st.TICKERS, generate_sample_tickers(
        hours=8, symbols=_symbols(unds=("btc",), exps=("28apr23", "30jun23"), cps="c")))
    RefRunner(ref_cfg, store=ref_store).run_task1()
    _, store = _stores(ref_store.read(ref_st.INTERPOLATED))
    assert task.run_surface_fit(cfg, store, device="cpu")["surfaces"] == 1
    df = store.read(task.SURFACES)
    assert {"local_vol", "density"} <= set(df.columns)
    assert np.isfinite(df["local_vol"]).all() and np.isfinite(df["density"]).all()
    assert (df["local_vol"] >= 0).all()

    cfg.surface.compute_local_vol = False
    cfg.surface.compensated = True
    store.drop(task.SURFACES)
    assert task.run_surface_fit(cfg, store, device="cpu")["surfaces"] == 1
    df = store.read(task.SURFACES)
    tv, lo = df["total_variance"].to_numpy(), df["total_variance_lo"].to_numpy()
    assert np.isfinite(lo).all() and np.any(lo != 0.0)
    assert (np.abs(lo) <= 1e-7 * np.maximum(np.abs(tv), 1e-6)).all()
    assert (df["fit_rmse"] == 0.0).all()
    cfg.surface.spline_bc = "clamped"
    with pytest.raises(ValueError, match="compensated"):
        task.run_surface_fit(cfg, store, device="cpu")


def test_surface_from_prices_when_iv_missing():
    """``tests/test_tools.py::test_surface_from_prices_when_iv_missing``:
    quotes with NaN iv and a mark price are inverted on the device."""
    from iv_interpolation_tpu_torch.ops.black_scholes import bs_price
    S, T, r = 25000.0, 0.25, 0.03
    strikes = np.array([22000, 23000, 24000, 25000, 26000, 27000.0])
    true_iv = 0.5 + 0.1 * np.log(strikes / S) ** 2
    f = lambda v: torch.tensor(v, dtype=torch.float64)
    prices = bs_price(f(S), torch.from_numpy(strikes), f(T), f(r), torch.from_numpy(true_iv),
                      torch.tensor(True)).numpy()
    df = pd.DataFrame({"symbol": [f"btc-27mar23-{int(k)}-c" for k in strikes],
                       "date": pd.Timestamp("2023-03-20"), "iv": np.nan,
                       "underlying_price": S, "time_to_maturity": T,
                       "mark_price": prices, "interest_rate": r})
    chains = task.build_chains(df, device="cpu")
    assert len(chains) == 1
    np.testing.assert_allclose(np.sort(chains[0]["iv"]), np.sort(true_iv), atol=1e-6)


def test_build_chains_dedupes_f32_colliding_strikes():
    """``tests/test_tools.py::test_build_chains_dedupes_f32_colliding_strikes``."""
    S = 25000.0
    strikes = [22000.0, 23000.0, 24000.0, S * np.exp(0.5), S * np.exp(0.5 + 1e-9), 42000.0]
    df = pd.DataFrame({"symbol": [f"btc-27mar23-{k:.6f}-c" for k in strikes],
                       "date": pd.Timestamp("2023-03-20"), "iv": 0.5,
                       "underlying_price": S, "time_to_maturity": 0.25})
    (chain,) = task.build_chains(df, device="cpu")
    k32 = chain["k"].astype(np.float32)
    assert (np.diff(k32) > 0).all() and len(k32) == 5
    (want,) = ref_task.build_chains(df)
    np.testing.assert_array_equal(chain["k"], want["k"])


def test_pack_chain_group_matches_jax(interpolated):
    chains = task.build_chains(interpolated, device="cpu")
    group = [("btc", [c for c in chains if c["underlying"] == "btc"]),
             ("eth", [c for c in chains if c["underlying"] == "eth"][:2])]
    for dtype in (np.float64, np.float32):
        got = task.pack_chain_group(group, 4, 8, dtype=dtype)
        want = ref_task.pack_chain_group(group, 4, 8, dtype=dtype)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_ah_chunking_and_refusals(interpolated, monkeypatch):
    """``surface.ah_max_batch`` chunks an 'ah' run's buckets (a wrapper
    of the AH family records the batch sizes) into the same table; a
    negative cap is refused (ROADMAP C4); a mesh larger than the launched
    world (one process: one rank) raises, naming the ranks, before the
    store is read."""
    seen = []
    get_model = models.get

    def get(name):
        model = get_model(name)
        fit_eval = model.fit_eval
        return models.SurfaceModel(
            name=name, attach_local_vol=model.attach_local_vol,
            fit_eval=lambda k, *a, **kw: seen.append(k.shape[0]) or fit_eval(k, *a, **kw))

    _, cfg = _configs(ah_grid=33, ah_iters=3)
    _, store = _stores(interpolated)
    monkeypatch.setattr(models, "get", get)
    cfg.surface.ah_max_batch = 1
    assert task.run_surface_fit(cfg, store, method="ah", device="cpu")["surfaces"] == 2
    assert seen == [1, 1]
    chunked = _sorted(store.read(task.SURFACES))
    seen.clear()
    cfg.surface.ah_max_batch = None
    task.run_surface_fit(cfg, store, method="ah", device="cpu")
    assert seen == [2]
    pd.testing.assert_frame_equal(chunked, _sorted(store.read(task.SURFACES)),
                                  check_exact=False, rtol=0, atol=1e-12)
    cfg.surface.ah_max_batch = -1
    with pytest.raises(ValueError, match="ah_max_batch"):
        task.run_surface_fit(cfg, store, method="ah", device="cpu")
    cfg.processing.mesh_shape = (2,)
    with pytest.raises(ValueError, match="needs 2 ranks; 1 launched"):
        task.run_surface_fit(cfg, store, device="cpu")


def test_empty_store_and_no_chains():
    _, cfg = _configs()
    assert task.run_surface_fit(cfg, st.MemoryStore(), device="cpu") == {
        "surfaces": 0, "reason": "no interpolated data"}
    store = st.MemoryStore()
    store.write(st.INTERPOLATED, pd.DataFrame({
        "symbol": ["not-a-symbol"], "date": [pd.Timestamp("2023-03-20")], "iv": [0.5],
        "underlying_price": [1.0], "time_to_maturity": [0.1]}))
    assert task.run_surface_fit(cfg, store, device="cpu")["reason"] == "no usable chains"


def test_surface_and_serve_import_nothing_of_jax(tmp_path):
    """In a process where ``jax`` and ``iv_interpolation_tpu`` cannot be
    imported, ``run_surface_fit`` runs on CPU tensors from a store the
    port's runner filled (with the splines, ah and rbf), readiness
    validates, and a JSONL serve round trip answers."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['iv_interpolation_tpu'] = None\n"
        "from iv_interpolation_tpu_torch import config\n"
        "from iv_interpolation_tpu_torch.pipeline import (runner, storage, sample_data,\n"
        "    surface_task, serve, flight_service, check_results)\n"
        "cfg = config.get_config('testing')\n"
        "cfg.interpolation.min_data_points = 5\n"
        "cfg.surface.grid_strikes = 10\n"
        "store = storage.MemoryStore()\n"
        "syms = [f'btc-{e}-{k}-c' for e in ('28apr23', '30jun23') for k in range(20000, 32000, 2000)]\n"
        "store.write(storage.TICKERS, sample_data.generate_sample_tickers(hours=8, symbols=syms))\n"
        "runner.PipelineRunner(cfg, store=store, device='cpu').run_task1()\n"
        "rep = surface_task.run_surface_fit(cfg, store, device='cpu')\n"
        "assert rep['surfaces'] == 1 and check_results.check_surface_results(store)['ok'], rep\n"
        "cfg.surface.ah_grid, cfg.surface.ah_iters = 33, 3\n"
        "for method in ('ah', 'rbf'):\n"
        "    rep = surface_task.run_surface_fit(cfg, store, method=method, device='cpu')\n"
        "    assert rep['surfaces'] == 1 and rep['butterfly_ok'] == 1, rep\n"
        "from iv_interpolation_tpu_torch.pipeline import validate\n"
        "assert validate.validate_readiness(cfg, store, device='cpu')['ready']\n"
        "srv = serve.run_serve(cfg, store, port=0, blocking=False, device='cpu')\n"
        "try:\n"
        "    ticks = [{'underlying': 'btc', 'minute': m, 'price': 100.0 + m % 7, 'size': 1.0}\n"
        "             for m in range(200)]\n"
        "    (reply,) = serve.send_lines('127.0.0.1', srv.port, ticks + [{'cmd': 'refit'}],\n"
        "                                timeout=60)\n"
        "finally:\n"
        "    srv.stop()\n"
        "assert reply['ok'] and reply['atm_iv']['btc'] > 0, reply\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'iv_interpolation_tpu')\n"
        "          and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]


def _mesh_table(interpolated):
    """The fixture's table plus 'sol' (a copy of btc: a bucket of 3
    underlyings, padded to 4 over 2 ranks) and 'xrp' (eth's first two
    expiries: a bucket of 1, padded to 2)."""
    sol = interpolated[interpolated["symbol"].str.startswith("btc-")].copy()
    sol["symbol"] = sol["symbol"].str.replace("btc-", "sol-", regex=False)
    xrp = interpolated[interpolated["symbol"].str.match(r"eth-(28apr23|30jun23)-")].copy()
    xrp["symbol"] = xrp["symbol"].str.replace("eth-", "xrp-", regex=False)
    return pd.concat([interpolated, sol, xrp], ignore_index=True)


def test_surface_task_over_a_mesh_equals_one_process(interpolated, tmp_path):
    """``run_surface_fit`` in a launched world of 2 gloo CPU ranks (each
    fits its block of every bucket; buckets whose B is no multiple of 2 are
    padded with masked rows) writes the one-process run's table: cubic and
    Andreasen-Huge exactly, flags too."""
    import json
    import pickle

    from iv_interpolation_tpu_torch.parallel import dryrun
    table = _mesh_table(interpolated)
    with open(tmp_path / "table.pkl", "wb") as f:
        pickle.dump(table, f)
    surface = {"ah_grid": 33, "ah_iters": 3}
    args = {"device": "cpu", "out": str(tmp_path), "table": str(tmp_path / "table.pkl"),
            "methods": ["cubic_spline", "ah"], "surface": surface}
    results = dryrun.spawn_world(2, ["-m", "iv_interpolation_tpu_torch.parallel._ranks",
                                     "surface", json.dumps(args)], timeout_s=60, wait_s=240)
    assert all(r["jax_free"] for r in results)
    _, cfg = _configs(**surface)
    for method in ("cubic_spline", "ah"):
        store = st.MemoryStore()
        store.write(st.INTERPOLATED, table)
        want = task.run_surface_fit(cfg, store, method=method, device="cpu")
        assert want["surfaces"] == 4
        # every rank returns rank 0's summary
        assert [r["result"][method] for r in results] == [want, want]
        with open(tmp_path / f"surface_{method}.pkl", "rb") as f:
            got = pickle.load(f)
        pd.testing.assert_frame_equal(_sorted(got), _sorted(store.read(task.SURFACES)),
                                      check_exact=True)
