"""Entry ``fit_eval_surface_essvi``: the port's general surface step with one
joint eSSVI surface a batch element, ``surface.surface.fit_eval_surface(k,
iv, T, method="essvi", n_grid, svi_iters, svi_weighting)``, on a batch of
surfaces that each quote their own strikes and maturities (the block
solver of ``ops.essvi.fit_essvi_batched`` calibrates every surface, with
its calendar hinge at the configuration's weight and grid, the port's
defaults)."""

from __future__ import annotations

import torch

from benchmark.entries import fit_eval_surface
from benchmark.reference import essvi, spline

KEPT = ("w_grid", "iv_grid", "butterfly_ok", "calendar_ok", "fit_rmse", "coefs")

setup = fit_eval_surface.setup
inputs = fit_eval_surface.inputs


def call(state: dict, slot: int) -> dict:
    x = state["pool"][slot]
    cfg = state["cfg"]
    return state["fn"](x["k"], x["iv"], x["T"], method=cfg["method"], n_grid=cfg["n_grid"],
                       svi_iters=cfg["lm_iters"], svi_weighting=cfg["weighting"])


def keep(out: dict) -> dict:
    """Copies of the outputs the comparison reads (a later call may reuse
    the program's buffers), the fitted parameters among them."""
    out = dict(out, coefs=out["fit"].coefs)
    return {name: out[name].clone() for name in KEPT}


def control(state: dict, slot: int) -> dict:
    """The reference in the program's place, computed in TF32 (the step
    below the float32 the configuration states): its own calibration and
    the kept outputs."""
    cfg = state["cfg"]
    x = inputs(state, slot)
    parts = []
    for lo in range(0, x["iv"].shape[0], essvi.BLOCK):
        sl = slice(lo, lo + essvi.BLOCK)
        k, iv, T = (spline.tf32(x[name][sl]) for name in ("k", "iv", "T"))
        coefs, _ = essvi.calibrate(k, iv, T, cfg["lm_iters"], cfg["calendar_weight"],
                                   cfg["n_penalty_grid"], spline.tf32)
        out = essvi.surface(coefs, k, iv, T, cfg["n_grid"], cfg["butterfly_tolerance"],
                            cfg["calendar_tolerance"], cfg["calendar_weight"],
                            cfg["n_penalty_grid"], spline.tf32)
        parts.append({"w_grid": out["w_grid"], "iv_grid": out["iv_grid"],
                      "butterfly_ok": out["butterfly_margin"] >= 0,
                      "calendar_ok": out["calendar_margin"] >= 0,
                      "fit_rmse": out["fit_rmse"], "coefs": coefs})
    return {name: torch.cat([p[name] for p in parts]) for name in KEPT}
