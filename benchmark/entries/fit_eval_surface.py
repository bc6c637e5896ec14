"""Entry ``fit_eval_surface``: the port's general surface step,
``surface.surface.fit_eval_surface(k, iv, T, method="cubic_spline",
n_grid, spline_bc)`` on a batch of surfaces that each quote their own
strikes and maturities (kernel B1 solves the splines)."""

from __future__ import annotations

import torch

from benchmark import generators
from benchmark.reference import spline

KEPT = ("w_grid", "iv_grid", "butterfly_ok", "calendar_ok")


def setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The pool of input batches, made on the device from the seed."""
    from iv_interpolation_tpu_torch.surface.surface import fit_eval_surface

    batch = traffic.get("batch", cfg["batch"])
    pool = [generators.surface_batch(seed, slot, batch, cfg["expiries"], cfg["strikes"],
                                     traffic, device)
            for slot in range(traffic["pool"])]
    return {"fn": fit_eval_surface, "pool": pool, "cfg": cfg, "batch": batch}


def call(state: dict, slot: int) -> dict:
    x = state["pool"][slot]
    cfg = state["cfg"]
    return state["fn"](x["k"], x["iv"], x["T"], method=cfg["method"], n_grid=cfg["n_grid"],
                       spline_bc=cfg["spline_bc"])


def keep(out: dict) -> dict:
    """Copies of the outputs the comparison reads (a later call may reuse
    the program's buffers)."""
    return {name: out[name].clone() for name in KEPT}


def inputs(state: dict, slot: int) -> dict:
    """Slot ``slot``'s quotes as the reference reads them: (B, E, n) k and
    iv, (B, E) T."""
    return state["pool"][slot]


def control(state: dict, slot: int) -> dict:
    """The reference in the program's place, computed in TF32 (the step
    below the float32 the configuration states): the kept outputs."""
    cfg = state["cfg"]
    x = inputs(state, slot)
    parts = []
    block = spline.BLOCK
    for lo in range(0, x["iv"].shape[0], block):
        sl = slice(lo, lo + block)
        k, iv, T = (spline.tf32(x[name][sl]) for name in ("k", "iv", "T"))
        out = spline.surface(k, iv, T, cfg["n_grid"], cfg["butterfly_tolerance"],
                             cfg["calendar_tolerance"], spline.tf32)
        parts.append({"w_grid": out["w_grid"], "iv_grid": out["iv_grid"],
                      "butterfly_ok": out["butterfly_margin"] >= 0,
                      "calendar_ok": out["calendar_margin"] >= 0})
    return {name: torch.cat([p[name] for p in parts]) for name in KEPT}
