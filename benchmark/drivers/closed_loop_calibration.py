"""Driver ``closed_loop_calibration``: ``closed_loop_batches``' closed loop
over a pool of input batches, for an entry whose surface step calibrates
its slices; judged against the float64 SVI reference.

A traced run also hands the per-layer readers what the calibration's own
tracing gives (none of it on a program without that tracing): the
profiled slice's device time by the program's spans, credited through
launch correlation (``benchmark.spans.device_by_span``), in
``ctx["spans"]``, and the advance of the batched Levenberg-Marquardt's
host counters over the slice in ``ctx["lm"]``.

``judge`` compares, for each kept call and block by block:

  * the replay: the program's fitted parameters evaluated by the reference
    in float64, against the program's ``w_grid``, ``iv_grid``, flags
    (``compare.surface_numbers``) and ``fit_rmse`` (``fit_rmse_rel_gap``);
  * the calibration: ``worse_fit_share``, the share of slices whose cost,
    recomputed in float64 from the program's parameters, exceeds the cost
    of the reference's own float64 calibration (the same start and
    iterations) by more than ``worse_fit_rel`` of it plus ``worse_fit_floor``.
"""

from __future__ import annotations

import torch

from benchmark import compare, spans, trace
from benchmark.drivers import closed_loop_batches
from benchmark.harness import Run
from benchmark.reference import svi

COUNTERS = ("calls", "iterations", "problems")


def _lm_counters():
    """The batched LM's host counters, or None where the program has none."""
    from iv_interpolation_tpu_torch.ops import lm
    fn = lm.levenberg_marquardt_batched
    if not all(hasattr(fn, name) for name in COUNTERS):
        return None
    return {name: getattr(fn, name) for name in COUNTERS}


def run(cell, seed: int, seconds: float, traced: bool, device, control: bool = False) -> Run:
    caught, lm = [], {}
    real_profile = trace.profile

    def profile(fn):
        before = _lm_counters()
        summary = real_profile(fn)
        after = _lm_counters()
        if before is not None and after is not None:
            lm.update({name: after[name] - before[name] for name in COUNTERS})
        return summary

    with trace.recording(trace, "summarize", lambda args, kwargs, result: caught.append(args[0])):
        trace.profile = profile
        try:
            out = closed_loop_batches.run(cell, seed, seconds, traced, device, control)
        finally:
            trace.profile = real_profile
    if caught:
        out.ctx["spans"] = spans.device_by_span(caught[-1])
        if lm:
            out.ctx["lm"] = lm
    return out


def judge(cell, run: Run) -> dict:
    """The compared numbers over every kept call, against the float64
    reference worked out from the slot's raw quotes, block by block."""
    cfg, limits = cell.config, cell.limits
    entry = cell.module("entry")
    numbers: dict = {}
    worse = slices = 0
    for slot, got in run.kept:
        x = entry.inputs(run.state, slot)
        for lo in range(0, x["iv"].shape[0], svi.BLOCK):
            sl = slice(lo, lo + svi.BLOCK)
            k, iv, T = (x[name][sl].double() for name in ("k", "iv", "T"))
            prog = {name: got[name][sl] for name in got}
            ref = svi.surface(prog["coefs"].double(), k, iv, T, cfg["n_grid"],
                              cfg["butterfly_tolerance"], cfg["calendar_tolerance"])
            part = surface_numbers(prog, ref, limits)
            _, best = svi.calibrate(k, iv, T, cfg["lm_iters"])
            bad = ~(ref["cost"] <= best * (1.0 + limits["worse_fit_rel"])
                    + limits["worse_fit_floor"])
            worse += int(bad.sum())
            slices += bad.numel()
            compare.merge(numbers, part)
    numbers["worse_fit_share"] = worse / max(slices, 1)
    return numbers


def surface_numbers(prog: dict, ref: dict, limits: dict) -> dict:
    """``compare.surface_numbers`` and ``fit_rmse_rel_gap``, the largest
    relative gap of the program's fit RMSE."""
    part = compare.surface_numbers(prog, ref, limits["flag_band_g"], limits["flag_band_w"])
    rmse_ref = ref["fit_rmse"]
    gap = (prog["fit_rmse"].to(rmse_ref.dtype) - rmse_ref).abs() / rmse_ref.abs().clamp_min(1e-300)
    part["fit_rmse_rel_gap"] = float(torch.nan_to_num(gap, nan=compare.INF).max())
    return part
