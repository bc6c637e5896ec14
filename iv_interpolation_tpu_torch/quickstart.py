"""Library quickstart of the port: fit surfaces, price Greeks, stream refits.

The counterpart of the JAX package's ``examples/quickstart.py``, in the
same seven sections, through the port's package-level names:

  1. surfaces: ``fit_eval_surface`` (cubic spline and eSSVI),
     ``eval_surface`` and ``local_vol_surface``;
  2. Greek surfaces of the cubic fit;
  3. SVI calibration and the arbitrage-aware smoothing spline;
  4. a ``StreamingSession``: ticks in, one refit;
  5. scattered quotes: an RBF surface with no-arbitrage penalties;
  6. Andreasen-Huge on quotes with a butterfly violation;
  7. the session behind an Arrow Flight server (where ``pyarrow.flight``
     imports).

Run from the repository root, on the card unless asked for the CPU:

    python -m iv_interpolation_tpu_torch.quickstart [--device cpu] [--seed 0] [--dtype float64]

float32 by default, as the JAX quickstart runs; ``--dtype float64`` runs
every section in float64, where the port is held to the JAX package
tightly (in float32 the scattered RBF fit of section 5, a saddle system
conditioned near 1e15, keeps no digit in either package).
:func:`make_inputs` builds every section's numpy inputs from a seed;
:func:`main` runs the sections and returns each one's results (tensors on
the device) with its wall seconds, and :func:`arrays` the results as
numpy, so tests and the card's smoke run can hold them.
"""

from __future__ import annotations

import argparse
import time
from contextlib import contextmanager

import numpy as np

SHAPE = dict(B=32, E=12, n=40)            # surfaces x expiries x strikes
UNDERLYINGS = 8                           # section 4's streaming universe
TICKS = 1000                              # ticks an underlying
WINDOW = 256                              # minutes
SCATTERED = 512                           # section 5's quotes
AH_SURFACES, AH_STRIKES = 4, 16           # section 6
SECTIONS = ("surfaces", "greeks", "calibration", "streaming", "rbf", "ah", "flight")

# How two runs of the tour agree (the port against the JAX functions in the
# CPU tests, the card against CPU tensors in ``chip_smoke.py``), by dtype,
# section and result, each the module's own tolerance from its parity
# tests: ("abs", t) |got - want| <= t; ("scale", t) <= t * max(1, max|want|);
# ("scale!", t) <= t * max|want|; ("rmse", t) the largest rmse within a
# relative t; ("rmse2", t) the largest squared rmse within a factor t;
# ("finite",) finite values only. Flags are always held exactly.
# Andreasen-Huge holds flags and price_rmse (two fits' LM paths part where
# a grid node lies 2.2e-8 from a quote-cell boundary, as here); float32
# RBF holds flags only (its saddle system is conditioned near 1e15).
_EPS32 = float(np.finfo(np.float32).eps)
_S32, _RV = 256 * _EPS32, 64 * _EPS32
_GREEKS = ("price", "delta", "gamma", "theta", "vega", "rho")
_STREAM = {"realized_vol": ("scale!", _RV), "w_grid": ("scale!", 2 * _RV),
           "iv_grid": ("scale!", 2 * _RV)}
TOLERANCES = {
    "float64": {
        "surfaces": {"w_grid": ("abs", 1e-12), "iv_grid": ("abs", 1e-12), "w_q": ("abs", 1e-12),
                     "g": ("scale", 1e-12), "local_vol": ("scale!", 1e-10),
                     "density": ("scale!", 1e-10), "var_swap": ("scale!", 1e-10),
                     "essvi_w_grid": ("scale!", 1e-7), "essvi_fit_rmse": ("scale!", 1e-7)},
        "greeks": {name: ("scale!", 1e-12) for name in _GREEKS},
        "calibration": {"svi_w": ("abs", 1e-8), "smoothed_g": ("abs", 1e-12),
                        "smoothed_M": ("scale", 1e-10)},
        "streaming": _STREAM,
        "rbf": {"w_at": ("scale!", 2e-6), "pen_w": ("scale!", 2e-6)},
        "ah": {"fit_rmse": ("rmse", 1e-4), "c": ("finite",), "w_mid": ("finite",)},
    },
    "float32": {
        "surfaces": {"w_grid": ("scale", _S32), "iv_grid": ("scale", _S32),
                     "w_q": ("scale", _S32), "g": ("scale", _S32), "local_vol": ("finite",),
                     "density": ("finite",), "var_swap": ("finite",),
                     "essvi_w_grid": ("scale!", 5e-5), "essvi_fit_rmse": ("rmse2", 1.5)},
        "greeks": {name: ("scale!", 8 * _EPS32) for name in _GREEKS},
        "calibration": {"svi_w": ("scale!", 5e-5), "smoothed_g": ("finite",),
                        "smoothed_M": ("finite",)},
        "streaming": _STREAM,
        "rbf": {"w_at": ("finite",), "pen_w": ("finite",)},
        "ah": {"fit_rmse": ("rmse", 1e-2), "c": ("finite",), "w_mid": ("finite",)},
    },
}


def make_inputs(seed: int = 0, dtype=np.float32) -> dict:
    """Every section's inputs as numpy arrays of ``dtype`` (the ticks as a
    pandas frame), drawn from ``seed`` in the JAX quickstart's order; the
    float64 inputs are the float32 ones widened."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    B, E, n = SHAPE["B"], SHAPE["E"], SHAPE["n"]
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    k = f32(np.broadcast_to(np.linspace(-1.0, 1.0, n, dtype=np.float32), (B, E, n)))
    T = f32(np.broadcast_to(np.linspace(0.05, 1.5, E, dtype=np.float32), (B, E)))
    iv = f32(0.35 + 0.08 * k**2 + 0.01 * rng.normal(size=(B, 1, 1)).astype(np.float32))
    w_slices = f32(iv**2 * T[..., None])
    noisy = f32(w_slices[0] + 0.002 * rng.normal(size=(E, n)).astype(np.float32))
    per_min = 0.5 / np.sqrt(365.25 * 24 * 60)   # 50 % annualised vol
    frames = []
    unds = [f"u{i}" for i in range(UNDERLYINGS)]
    for u in unds:
        minutes = np.sort(rng.integers(0, WINDOW, TICKS))
        path = 100 * np.exp(np.cumsum(rng.normal(0, per_min, WINDOW)))
        frames.append(pd.DataFrame({
            "underlying": u, "minute": minutes,
            "price": path[minutes],            # ticks sample the minute path
            "size": rng.uniform(0, 5, TICKS)}))
    kq = rng.uniform(-1, 1, SCATTERED)
    Tq = rng.uniform(0.05, 2.0, SCATTERED)
    wq = (0.04 + 0.3 * kq**2) * Tq + 0.01 * np.sin(8 * kq) * Tq   # arbitrage
    iv_arby = iv[:AH_SURFACES, :, :AH_STRIKES].copy()
    iv_arby[:, :, AH_STRIKES // 2] *= 1.4     # butterfly violation at the money
    out = {"k": k, "T": T, "iv": iv, "w_slices": w_slices, "noisy": noisy,
           "lams": f32([1e-8, 1e-5, 1e-3, 1e-1]), "points": f32(np.stack([kq, Tq], -1)),
           "wq": f32(wq), "iv_arby": iv_arby}
    out = {name: a.astype(dtype) for name, a in out.items()}
    return {**out, "underlyings": unds, "ticks": pd.concat(frames, ignore_index=True)}


def main(device: str = "cuda", seed: int = 0, dtype: str = "float32",
         verbose: bool = True) -> dict:
    """Run the seven sections on ``device`` in ``dtype``; returns
    ``{"inputs", "seconds": {section: wall s}, <section>: results}``."""
    import torch

    say = print if verbose else (lambda *a, **k: None)
    device = torch.device(device)
    np_dtype = np.dtype(dtype).type
    inp = make_inputs(seed, np_dtype)
    dev = lambda a: torch.as_tensor(a, device=device)
    k, T, iv = dev(inp["k"]), dev(inp["T"]), dev(inp["iv"])
    B = k.shape[0]
    res = {"inputs": inp, "seconds": {}}

    @contextmanager
    def section(name):
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        res["seconds"][name] = time.perf_counter() - t0

    # 1. a batch of vol surfaces (any smile family)
    with section("surfaces"):
        from iv_interpolation_tpu_torch.surface import (eval_surface, fit_eval_surface,
                                                        local_vol_surface)

        out = fit_eval_surface(k, iv, T, method="cubic_spline", n_grid=50)
        # arbitrary-point queries (total variance, linear in maturity)
        w_q = eval_surface(out["fit"], dev(np.zeros((B, 1), np_dtype)),
                           dev(np.full((B, 1), 0.7, np_dtype)))
        # Dupire local vol and the risk-neutral density on the same grid
        lv = local_vol_surface(out)
        # eSSVI: one joint fit a surface, butterfly-free slices and
        # increasing ATM variance by construction
        out_e = fit_eval_surface(k, iv, T, method="essvi", n_grid=50, svi_iters=48)
    res["surfaces"] = {"cubic": out, "w_q": w_q, "local_vol": lv, "essvi": out_e}
    say("surface grid:", tuple(out["w_grid"].shape),
        "| butterfly-free:", int(out["butterfly_ok"].sum()), "/", B,
        "| calendar-free:", int(out["calendar_ok"].sum()), "/", B)
    say("w(k=0, T=0.7) sample:", float(w_q[0, 0]))
    say("local vol grid:", tuple(lv["local_vol"].shape),
        "| admits real local vol:", int(lv["local_vol_ok"].sum()), "/", B)
    say("essvi butterfly-free:", int(out_e["butterfly_ok"].sum()), "/", B)

    # 2. Greek surfaces from the fit
    with section("greeks"):
        from iv_interpolation_tpu_torch.surface.greeks import greek_surfaces

        g = greek_surfaces(out["k_grid"], out["iv_grid"], out["fit"].expiries,
                           dev(np.full((B,), 25_000.0, np_dtype)), 0.03, is_call=True)
    res["greeks"] = g
    say("delta grid:", tuple(g["delta"].shape),
        "| atm delta sample:", round(float(g["delta"][0, 0, 25]), 4))

    # 3. SVI and smoothing-spline smile calibration
    with section("calibration"):
        from iv_interpolation_tpu_torch.models.svi import fit_svi_batched, svi_total_variance
        from iv_interpolation_tpu_torch.ops.smoothing_spline import (
            fit_smoothing_spline_autolam)

        w_slices = dev(inp["w_slices"])
        svi = fit_svi_batched(k, w_slices, max_iters=60, init="quasi")
        svi_w = svi_total_variance(svi.params, k)
        smoothed = fit_smoothing_spline_autolam(k[0], dev(inp["noisy"]), dev(inp["lams"]))
    res["calibration"] = {"svi": svi, "svi_w": svi_w, "smoothed": smoothed}
    say("svi max |residual|:", float((svi_w - w_slices).abs().max()))
    say("auto-lam smoothing: max adjustment",
        float((smoothed.g - dev(inp["noisy"])).abs().max()))

    # 4. streaming: ticks -> candles -> realized vol -> refit
    with section("streaming"):
        from iv_interpolation_tpu_torch.pipeline.stream_service import StreamingSession

        n_u = len(inp["underlyings"])
        sess = StreamingSession(inp["underlyings"], k[:n_u], iv[:n_u], T[:n_u],
                                window_minutes=WINDOW, n_grid=20, device=device)
        sess.ingest_ticks(inp["ticks"])
        refit = sess.refit()
    res["streaming"] = refit
    say("streaming refit:", tuple(refit.iv_grid.shape),
        "| realized vol mean:", round(float(refit.realized_vol.mean()), 3))

    # 5. scattered quotes: an RBF surface with no-arbitrage penalty repair
    with section("rbf"):
        from iv_interpolation_tpu_torch.ops.rbf import eval_rbf, fit_rbf_arbfree

        fit = fit_rbf_arbfree(dev(inp["points"]), dev(inp["wq"]), n_iters=24)
        w_at = eval_rbf(fit, dev(np.array([[0.0, 1.0]], np_dtype)))
    res["rbf"] = {"fit": fit, "w_at": w_at}
    say("rbf arbfree: butterfly-free:", bool(fit["butterfly_ok"]),
        "| calendar-free:", bool(fit["calendar_ok"]),
        "| w(0, 1y):", round(float(w_at[0]), 4))

    # 6. Andreasen-Huge: arbitrage-free by construction, even on quotes
    #    with arbitrage and between quoted maturities
    with section("ah"):
        from iv_interpolation_tpu_torch.ops.andreasen_huge import eval_ah, fit_eval_ah_surface

        ah = fit_eval_ah_surface(k[:AH_SURFACES, :, :AH_STRIKES], dev(inp["iv_arby"]),
                                 T[:AH_SURFACES], n_grid=129, n_iters=8)
        w_mid = eval_ah(ah["fit"], dev(np.zeros((AH_SURFACES, 1), np_dtype)),
                        dev(np.full((AH_SURFACES, 1), 0.5, np_dtype)))
    res["ah"] = {**ah, "w_mid": w_mid}
    say("andreasen-huge on quotes with arbitrage: butterfly-free:",
        int(ah["butterfly_ok"].sum()), "/", AH_SURFACES,
        "| calendar-free:", int(ah["calendar_ok"].sum()), "/", AH_SURFACES,
        "| w(0, 0.5y):", round(float(w_mid[0, 0]), 4))

    # 7. serving: the same session over Arrow Flight (columnar gRPC)
    from iv_interpolation_tpu_torch.pipeline import flight_service as fs

    res["flight"] = None
    if fs.HAVE_FLIGHT:
        with section("flight"):
            import pyarrow.flight as fl

            srv = fs.FlightStreamServer(sess, port=0)
            try:
                client = fl.connect(f"grpc+tcp://127.0.0.1:{srv.port}")
                try:
                    tbl = client.do_get(fl.Ticket(b"refit")).read_all()
                finally:
                    client.close()
            finally:
                srv.shutdown()
        res["flight"] = tbl.to_pydict()
        say("flight refit table:", tbl.num_rows, "underlyings,",
            "cols:", tbl.column_names)
    else:
        say("pyarrow.flight unavailable: JSONL server only (pipeline/serve.py)")
    say("section seconds:", {s: round(v, 3) for s, v in res["seconds"].items()})
    return res


def arrays(res: dict) -> dict:
    """The results of :func:`main` as numpy, by section and name (flags
    as bool); section 7 is absent where Flight did not run."""
    host = lambda t: t.detach().cpu().numpy()
    s, lv, e = res["surfaces"], res["surfaces"]["local_vol"], res["surfaces"]["essvi"]
    cal, st, rbf, ah = res["calibration"], res["streaming"], res["rbf"], res["ah"]
    out = {
        "surfaces": {"w_grid": s["cubic"]["w_grid"], "iv_grid": s["cubic"]["iv_grid"],
                     "g": s["cubic"]["g"], "butterfly_ok": s["cubic"]["butterfly_ok"],
                     "calendar_ok": s["cubic"]["calendar_ok"], "w_q": s["w_q"],
                     "local_vol": lv["local_vol"], "density": lv["density"],
                     "local_vol_ok": lv["local_vol_ok"], "var_swap": lv["var_swap"],
                     "essvi_w_grid": e["w_grid"], "essvi_fit_rmse": e["fit_rmse"],
                     "essvi_butterfly_ok": e["butterfly_ok"],
                     "essvi_calendar_ok": e["calendar_ok"]},
        "greeks": dict(res["greeks"]),
        "calibration": {"svi_w": cal["svi_w"], "smoothed_g": cal["smoothed"].g,
                        "smoothed_M": cal["smoothed"].M},
        "streaming": {"w_grid": st.w_grid, "iv_grid": st.iv_grid,
                      "realized_vol": st.realized_vol, "butterfly_ok": st.butterfly_ok,
                      "calendar_ok": st.calendar_ok},
        "rbf": {"w_at": rbf["w_at"], "pen_w": rbf["fit"]["pen_w"],
                "butterfly_ok": rbf["fit"]["butterfly_ok"],
                "calendar_ok": rbf["fit"]["calendar_ok"]},
        "ah": {"w_mid": ah["w_mid"], "c": ah["fit"].c, "fit_rmse": ah["fit_rmse"],
               "butterfly_ok": ah["butterfly_ok"], "calendar_ok": ah["calendar_ok"]},
    }
    out = {sec: {name: host(t) for name, t in d.items()} for sec, d in out.items()}
    if res["flight"] is not None:
        out["flight"] = {name: np.asarray(v) for name, v in res["flight"].items()
                         if name != "underlying"}
    return out


def hold(got: dict, want: dict, dtype: str, section: str) -> dict:
    """Hold one section of :func:`arrays` (``got``) to another run's
    (``want``) at :data:`TOLERANCES`; raises AssertionError naming the
    first result out of bounds. Returns each result's gap (flags: the
    count that differ)."""
    rules, gaps = TOLERANCES[dtype].get(section, {}), {}
    for name, w in want.items():
        g, what = got[name], f"{dtype} {section} {name}"
        if g.shape != w.shape:
            raise AssertionError(f"{what}: shape {g.shape} != {w.shape}")
        if w.dtype == bool:
            gaps[name] = int((g != w).sum())
            if gaps[name]:
                raise AssertionError(f"{what}: {gaps[name]} flags differ")
            continue
        if not np.isfinite(g).all():
            raise AssertionError(f"{what}: not finite")
        kind, *t = rules[name]
        if kind == "finite":
            gaps[name] = float(np.abs(g.astype(np.float64) - w).max())
            continue
        if kind in ("rmse", "rmse2"):
            ratio = float(g.max() / w.max())
            gaps[name] = abs(ratio - 1.0) if kind == "rmse" else abs(ratio**2 - 1.0)
            ok = gaps[name] <= t[0] if kind == "rmse" else 1 / t[0] <= ratio**2 <= t[0]
            if not ok:
                raise AssertionError(f"{what}: rmse {g.max():.6e} against {w.max():.6e}")
            continue
        scale = float(np.abs(w).max())
        bound = {"abs": t[0], "scale": t[0] * max(1.0, scale), "scale!": t[0] * scale}[kind]
        gaps[name] = float(np.abs(g.astype(np.float64) - w).max())
        if gaps[name] > bound:
            raise AssertionError(f"{what}: {gaps[name]:.3e} > {bound:.3e}")
    return gaps


def cli(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: the card; 'cpu' for CPU tensors)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    args = parser.parse_args(argv)
    main(device=args.device, seed=args.seed, dtype=args.dtype)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
