"""Entry ``fit_eval_surface_grid``: the port's operator form,
``ops.spline_matrix.fit_eval_surface_grid(ops, iv, T)``, on surfaces that
all quote one standardised strike grid and one maturity ladder. The
operators come from ``build_surface_operators(knots, queries,
bc_type=spline_bc)``, built once in set-up over the common support of the
knots; a call is one float32 contraction and the flags (no B1, no bracket
search)."""

from __future__ import annotations

import torch

from benchmark import generators
from benchmark.entries.fit_eval_surface import keep  # the same outputs are kept


def setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    from iv_interpolation_tpu_torch.ops.spline_matrix import (build_surface_operators,
                                                              fit_eval_surface_grid)
    from iv_interpolation_tpu_torch.surface.surface import common_support_grid

    batch = traffic.get("batch", cfg["batch"])
    pool = [generators.surface_batch(seed, slot, batch, cfg["expiries"], cfg["strikes"],
                                     traffic, device)
            for slot in range(traffic["pool"])]
    knots = pool[0]["k"]
    queries = common_support_grid(knots, cfg["n_grid"])
    ops = build_surface_operators(knots, queries, bc_type=cfg["spline_bc"])
    return {"fn": fit_eval_surface_grid, "ops": ops, "pool": pool, "cfg": cfg,
            "batch": batch}


def call(state: dict, slot: int) -> dict:
    x = state["pool"][slot]
    return state["fn"](state["ops"], x["iv"], x["T"])


def inputs(state: dict, slot: int) -> dict:
    """Slot ``slot``'s quotes as the reference reads them: the shared knots
    and maturities broadcast to (B, E, n) and (B, E)."""
    x = state["pool"][slot]
    B, E, n = x["iv"].shape
    return {"k": x["k"].expand(B, E, n), "iv": x["iv"], "T": x["T"].expand(B, E)}


def control(state: dict, slot: int) -> dict:
    """The program with its own lower-precision path on: the contraction
    in TF32 (``allow_tf32``), which the configuration holds off."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        return keep(call(state, slot))
    finally:
        matmul.allow_tf32 = before
