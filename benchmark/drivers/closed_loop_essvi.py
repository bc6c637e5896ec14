"""Driver ``closed_loop_essvi``: ``closed_loop_batches``' closed loop over a
pool of input batches, for an entry whose surface step calibrates one joint
eSSVI surface a batch element; judged against the float64 eSSVI reference.

A traced run also hands the per-layer readers what the calibration's own
tracing gives (none of it on a program without that tracing): the
profiled slice's device time by the program's spans, credited through
launch correlation (``benchmark.spans.device_by_span``), in
``ctx["spans"]``; the kernels of the slice launched inside an
``iv.essvi.solve`` span in ``ctx["essvi_solve_launches"]``; and the advance
of ``fit_essvi_batched``'s host counters over the slice in ``ctx["essvi"]``.

``judge`` compares, for each kept call and block by block:

  * the replay: the program's fitted parameters evaluated by the reference
    in float64, against the program's ``w_grid``, ``iv_grid``, flags
    (``compare.surface_numbers``) and ``fit_rmse`` (``fit_rmse_rel_gap``);
  * ``structure_violations``: slices of the program's parameters that break
    the structural guarantees (theta non-decreasing in expiry, |rho| < 1,
    0 < psi <= the butterfly cap), counted exactly;
  * the calibration: ``worse_fit_share``, the share of surfaces whose cost
    (data term and calendar hinge), recomputed in float64 from the
    program's parameters, exceeds the cost of the reference's own float64
    calibration (the same start and iterations) by more than
    ``worse_fit_rel`` of it plus ``worse_fit_floor``.
"""

from __future__ import annotations

import bisect

from benchmark import compare, spans, trace
from benchmark.drivers import closed_loop_batches
from benchmark.drivers.closed_loop_calibration import surface_numbers
from benchmark.harness import Run
from benchmark.reference import essvi

COUNTERS = ("calls", "iterations", "surfaces")
SOLVE = "iv.essvi.solve"


def _counters():
    """``fit_essvi_batched``'s host counters, or None where the program has
    none."""
    from iv_interpolation_tpu_torch.ops import essvi as port
    fn = port.fit_essvi_batched
    if not all(hasattr(fn, name) for name in COUNTERS + ("by_solver",)):
        return None
    return {**{name: getattr(fn, name) for name in COUNTERS},
            "by_solver": dict(fn.by_solver)}


def _advance(before: dict, after: dict) -> dict:
    out = {name: after[name] - before[name] for name in COUNTERS}
    out["by_solver"] = {key: after["by_solver"][key] - before["by_solver"].get(key, 0)
                        for key in after["by_solver"]}
    return out


def launches_inside(events: list, name: str):
    """Kernels of the slice whose launch falls inside a span called ``name``
    on the launching thread, found through their launch's correlation id;
    None where the trace holds no such span."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    mark = next(e for e in complete
                if e.get("name") == trace.SLICE and e.get("cat") == "user_annotation")
    w0 = float(mark["ts"])
    w1 = w0 + float(mark["dur"])
    inside: dict = {}                # thread -> sorted [start, end) of the spans
    for e in complete:
        if e.get("cat") == "user_annotation" and e["name"].split("[", 1)[0] == name:
            inside.setdefault((e.get("pid"), e.get("tid")), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    if not inside:
        return None
    for items in inside.values():
        items.sort()
    launches = {e["args"]["correlation"]: e for e in complete
                if e.get("cat") in spans.LAUNCH_CATS and "correlation" in e.get("args", {})}
    count = 0
    for e in complete:
        if e.get("cat") != "kernel" or not w0 <= float(e["ts"]) < w1:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        items = inside.get((launch.get("pid"), launch.get("tid")), [])
        t = float(launch["ts"])
        # the spans of one name do not overlap: the last that starts by t
        j = bisect.bisect_right(items, (t, float("inf"))) - 1
        count += j >= 0 and t <= items[j][1]
    return count


def run(cell, seed: int, seconds: float, traced: bool, device, control: bool = False) -> Run:
    caught, advance = [], {}
    real_profile = trace.profile

    def profile(fn):
        before = _counters()
        summary = real_profile(fn)
        after = _counters()
        if before is not None and after is not None:
            advance.update(_advance(before, after))
        return summary

    with trace.recording(trace, "summarize", lambda args, kwargs, result: caught.append(args[0])):
        trace.profile = profile
        try:
            out = closed_loop_batches.run(cell, seed, seconds, traced, device, control)
        finally:
            trace.profile = real_profile
    if caught:
        out.ctx["spans"] = spans.device_by_span(caught[-1])
        solve = launches_inside(caught[-1], SOLVE)
        if solve is not None:
            out.ctx["essvi_solve_launches"] = solve
        if advance:
            out.ctx["essvi"] = advance
    return out


def judge(cell, run: Run) -> dict:
    """The compared numbers over every kept call, against the float64
    reference worked out from the slot's raw quotes, block by block."""
    cfg, limits = cell.config, cell.limits
    cw, m = cfg["calendar_weight"], cfg["n_penalty_grid"]
    entry = cell.module("entry")
    numbers: dict = {"structure_violations": 0}
    worse = surfaces = 0
    for slot, got in run.kept:
        x = entry.inputs(run.state, slot)
        for lo in range(0, x["iv"].shape[0], essvi.BLOCK):
            sl = slice(lo, lo + essvi.BLOCK)
            k, iv, T = (x[name][sl].double() for name in ("k", "iv", "T"))
            prog = {name: got[name][sl] for name in got}
            coefs = prog["coefs"].double()
            ref = essvi.surface(coefs, k, iv, T, cfg["n_grid"], cfg["butterfly_tolerance"],
                                cfg["calendar_tolerance"], cw, m)
            part = surface_numbers(prog, ref, limits)
            part["structure_violations"] = essvi.structure_violations(prog["coefs"])
            _, best = essvi.calibrate(k, iv, T, cfg["lm_iters"], cw, m)
            bad = ~(ref["cost"] <= best * (1.0 + limits["worse_fit_rel"])
                    + limits["worse_fit_floor"])
            worse += int(bad.sum())
            surfaces += bad.numel()
            compare.merge(numbers, part)
    numbers["worse_fit_share"] = worse / max(surfaces, 1)
    return numbers
